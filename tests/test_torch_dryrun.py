"""The port's ``dryrun_multichip`` (``simhand_tpu_torch/dryrun.py``), the
counterpart of ``__graft_entry__.py``'s, on the CPU: two rank processes
over gloo, in a subprocess under a deadline."""
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
DEADLINE_S = 240


def test_dryrun_multichip_two_ranks_on_the_cpu(tmp_path):
    """Every arm prints JAX's OK line: the data-parallel simhand_w step,
    the detnet mesh step, FSDP on the (1, 2) hybrid mesh with the state
    sharded, ring mining against the all-pairs oracle and the sharded
    kernel NT-Xent against the dense loss."""
    code = ("from simhand_tpu_torch.dryrun import dryrun_multichip; "
            "dryrun_multichip(2, device='cpu')")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=DEADLINE_S,
                         env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    lines = [line for line in out.stdout.splitlines() if line.startswith("dryrun_multichip(2)")]
    assert [line.split(": ", 1)[1].split()[0].split("=")[0] for line in lines] == [
        "contrastive_loss", "det_total", "fsdp{'data':", "ring_mining",
        "sharded_pallas_ntxent"]
    assert all(line.endswith("OK") for line in lines)
