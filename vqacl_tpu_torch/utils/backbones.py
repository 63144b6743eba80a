"""Backbone weight acquisition (counterpart of ``vqacl_tpu/utils/
backbones.py`` and the reference's ``download_backbones.py``).

Nothing is fetched: the port reads weights from local files only
(``models/hf_import.py::load_t5_base``). ``download_backbones`` reports,
for each name, where its checkpoint was found on disk, or where to put
one.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

_WEIGHTS = ("model.safetensors", "pytorch_model.bin")


def download_backbones(names=("t5-base",), cache_dir: Optional[str] = None
                       ) -> dict:
    """{name: status}: ``"ok (<dir>)"`` for a local checkpoint directory
    (``name`` itself, ``cache_dir/models--<name>/snapshots/*`` or the HF
    cache on disk), else ``"unavailable (...)"`` with where to place
    one."""
    from vqacl_tpu_torch.models.hf_import import _hf_cache_pattern

    status = {}
    for name in names:
        dirs = [name] if os.path.isdir(name) else []
        if cache_dir:
            dirs += sorted(glob.glob(os.path.join(
                cache_dir, "models--" + name.replace("/", "--"),
                "snapshots", "*")))
        dirs += sorted(glob.glob(_hf_cache_pattern(name)))
        found = [d for d in dirs
                 if any(os.path.exists(os.path.join(d, w)) for w in _WEIGHTS)]
        if found:
            status[name] = f"ok ({found[0]})"
        else:
            status[name] = (
                f"unavailable (no local checkpoint; nothing is downloaded); "
                f"place a local checkpoint dir ({' or '.join(_WEIGHTS)}) and "
                f"pass its path as --backbone, and spiece.model as "
                f"--tokenizer")
    return status


if __name__ == "__main__":
    for k, v in download_backbones().items():
        print(f"{k}: {v}")
