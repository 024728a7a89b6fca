"""PickleJar: machine-portable on-disk memoization of experiment results.

Counterpart of ``gpu_se_tpu/utils/cache.py``: joblib memoization keyed
by the function's *name* (not its module path) so that a jar ships
across machines, with ``force_same_code`` pinning the stored source to
suppress staleness invalidation and ``force_rerun`` to clear one memo.

The port's jar has its own root, ``<repo>/picklejar_torch/<path>/``
(``GPU_SE_TORCH_PICKLEJAR_ROOT`` moves it): the memos are keyed by name
alone, so under the reference's ``picklejar/`` a port function would be
served the reference's memo of the same name.
"""
from __future__ import annotations

import os

import joblib
import joblib.memory

global_cache_settings = {
    "force_rerun": False,
    "force_same_code": True,
}

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROOT_ENV = "GPU_SE_TORCH_PICKLEJAR_ROOT"


def default_root() -> str:
    """The jar's root: ``$GPU_SE_TORCH_PICKLEJAR_ROOT`` if set, else
    ``<repo>/picklejar_torch``."""
    return os.environ.get(ROOT_ENV, os.path.join(_REPO_ROOT, "picklejar_torch"))


class PickleJar(joblib.memory.MemorizedFunc):
    """Disk-memoized function with machine-independent identity."""

    def __init__(self, func, location="", cache_settings=None, root=None):
        if cache_settings is None:
            cache_settings = global_cache_settings
        self.cache_settings = cache_settings

        joblib.memory._build_func_identifier = lambda f: f.__name__

        location = os.path.join(default_root() if root is None else root,
                                location)
        super().__init__(func, location)

        # joblib drops a '.gitignore' with '*' into every cache directory
        # it creates, which would keep the memos out of git; the jar is
        # meant to be committed, so scrub them
        for dirpath, _dirs, files in os.walk(location):
            if ".gitignore" in files:
                try:
                    os.remove(os.path.join(dirpath, ".gitignore"))
                except OSError:
                    pass

        if self.cache_settings["force_same_code"]:
            func_code, source_file, first_line = joblib.memory.get_func_code(self.func)
            self._write_func_code(func_code, first_line)

    @staticmethod
    def pickle(path, root=None):
        """Decorator factory: ``@PickleJar.pickle('pf/raw')``. ``root``
        pins the cache directory whatever ``GPU_SE_TORCH_PICKLEJAR_ROOT``
        says."""
        return lambda fun: PickleJar(fun, path, root=root)

    def clear_single(self, *args, **kwargs):
        """Drop the memo for one argument tuple."""
        self.call_and_shelve(*args, **kwargs).clear()

    def __call__(self, *args, **kwargs):
        if self.cache_settings["force_rerun"]:
            self.clear_single(*args, **kwargs)
        return super().__call__(*args, **kwargs)
