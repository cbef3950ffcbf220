"""Small shared helpers (counterpart of ``simhand_tpu/utils/__init__.py``):
JSON and YAML reading, JSON writing, a console logger.

The standard library's ``logging`` is bound under another name: importing
the submodule ``utils.logging`` sets this package's attribute ``logging``.
"""
import json
import logging as _logging


def read_json(path: str):
    with open(path) as f:
        return json.load(f)


def save_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def read_yaml(path: str):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def get_console_logger(name: str = "simhand_tpu_torch") -> _logging.Logger:
    lg = _logging.getLogger(name)
    if not lg.handlers:
        h = _logging.StreamHandler()
        h.setFormatter(_logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        lg.addHandler(h)
        lg.setLevel(_logging.INFO)
    return lg
