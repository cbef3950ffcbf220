"""Env-keyed paths (counterpart of ``simhand_tpu/constants.py``), read when
the module is imported, as the JAX package reads them."""
import os

# the default run dir's name differs from the package's: a sys.path entry
# holding a "simhand_tpu_torch/" data directory would shadow the package
BASE_PATH = os.environ.get("BASE_PATH", "/tmp/simhand_runs")
DATA_PATH = os.environ.get("DATA_PATH", os.path.join(BASE_PATH, "data"))
HAND2M_DATA = os.environ.get("HAND2M_DATA", DATA_PATH)
FREIHAND_DATA = os.environ.get("FREIHAND_DATA", os.path.join(DATA_PATH, "freihand"))
YOUTUBE_DATA = os.environ.get("YOUTUBE_DATA", os.path.join(DATA_PATH, "youtube"))
SAVED_MODELS_BASE_PATH = os.environ.get(
    "SAVED_MODELS_BASE_PATH", os.path.join(BASE_PATH, "saved_models")
)
SAVED_META_INFO_PATH = os.environ.get(
    "SAVED_META_INFO_PATH", os.path.join(BASE_PATH, "meta")
)
TENSORBOARD_LOGS = os.environ.get(
    "TENSORBOARD_LOGS", os.path.join(BASE_PATH, "tb_logs")
)
