"""The port's grand loop (``simhand_tpu_torch.transfer_check.run_grand_loop``)
on the CPU: the corpus's annotation written without frames, the mining CLI,
a crop cache with the mined positives, pre-training on it with
``--export_torch``, the fine-tune from that export, and ``finetune.evaluate``
on its checkpoint, at 64 hands, ResNet-18, B = 8, 2 + 2 steps. Checked: the
mined top-1 equals ``top1_cross_video``'s, the export is in the detnet bit
for bit before its first step, the evaluation's metrics are finite. Once in
this process, once in one where cv2, yaml, matplotlib and jax cannot be
imported, as on the card's machine.

This module imports no JAX: the second case imports it in that process.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent
BLOCKED = ("cv2", "yaml", "matplotlib", "jax")


def checked_grand_loop(workdir: str) -> dict:
    """``run_grand_loop`` on the CPU at the test's size, with the export's
    landing recorded when the fine-tune makes its step; returns what the
    test checks."""
    from simhand_tpu_torch import transfer_check as T
    from simhand_tpu_torch.finetune import train as ft

    export = os.path.join(workdir, "encoder_pretrained.pth")
    landed = []
    real = ft.make_detnet_train_step

    def landing(model, *a, **k):
        sd = torch.load(export, weights_only=True)
        enc = {k: v for k, v in model.encoder.resnet.state_dict().items()
               if not k.endswith("num_batches_tracked")}
        landed.append(sd.keys() == enc.keys() and all(torch.equal(sd[k], enc[k]) for k in sd))
        return real(model, *a, **k)

    ft.make_detnet_train_step = landing
    try:
        record = T.run_grand_loop(workdir, images=64, batch_size=8, resnet_size="18",
                                  pretrain_steps=2, finetune_steps=2, device="cpu")
    finally:
        ft.make_detnet_train_step = real
    mining = record["mining"]
    return {"mined_equal_oracle": bool(np.array_equal(mining["positives"], mining["oracle"])),
            "other_video": bool(((mining["positives"] % 16) != (np.arange(64) % 16)).all()),
            "landed": landed, "pretrain_step": record["pretrain"]["step"],
            "finetune_step": record["finetune"]["step"],
            "lossH_final": record["finetune"]["lossH_final"],
            "metrics": {k: v for k, v in record["evaluate"].items() if isinstance(v, float)},
            "stages": sorted(record)}


@pytest.mark.parametrize("where", ["in_process", "blocked_imports"])
def test_grand_loop_mines_pretrains_exports_finetunes_and_evaluates(tmp_path, monkeypatch,
                                                                   where):
    env = {"BASE_PATH": str(tmp_path / "runs"), "TENSORBOARD_LOGS": ""}
    workdir = str(tmp_path / "loop")
    if where == "in_process":
        import importlib

        import simhand_tpu_torch.constants as constants

        for k, v in env.items():
            monkeypatch.setenv(k, v)
        importlib.reload(constants)
        try:
            got = checked_grand_loop(workdir)
        finally:
            monkeypatch.undo()
            importlib.reload(constants)
    else:
        script = textwrap.dedent(f"""
            import json, sys
            for name in {BLOCKED!r}:
                sys.modules[name] = None
            sys.path.insert(0, {str(REPO / "tests")!r})
            from test_torch_grand_loop import checked_grand_loop
            print(json.dumps(checked_grand_loop({workdir!r})))
        """)
        res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                             timeout=300, env={**os.environ, **env, "PYTHONPATH": str(REPO)},
                             cwd=tmp_path)
        assert res.returncode == 0, res.stderr[-4000:]
        got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["stages"] == sorted(["corpus", "mining", "cache", "pretrain", "finetune",
                                    "evaluate"])
    assert got["mined_equal_oracle"] and got["other_video"]
    assert got["landed"] == [True]
    assert got["pretrain_step"] == got["finetune_step"] == 2
    assert np.isfinite(got["lossH_final"])
    assert got["metrics"] and all(np.isfinite(v) for v in got["metrics"].values())


def test_workflow_checks_need_a_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """Without a card both functions and the command line raise before they
    write anything, unless given device="cpu"; a non-empty workdir is
    refused."""
    from simhand_tpu_torch import transfer_check as T

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setenv("BASE_PATH", str(tmp_path / "runs"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_transfer_check(str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.run_grand_loop(str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--workdir", str(tmp_path / "c")])
    assert not any(tmp_path.iterdir())
    (tmp_path / "d").mkdir()
    (tmp_path / "d" / "x").write_text("")
    with pytest.raises(FileExistsError):
        T.run_grand_loop(str(tmp_path / "d"), device="cpu")
