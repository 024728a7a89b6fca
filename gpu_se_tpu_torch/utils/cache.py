"""PickleJar: machine-portable on-disk memoization of experiment results.

Counterpart of ``gpu_se_tpu/utils/cache.py``, with the same contract and
no joblib (the card's machine has none):

* a memo is keyed by the function's *name* (not its module path, so a
  jar ships across machines) and a hash of its bound arguments, defaults
  filled in; numpy arrays hash by dtype, shape and bytes;
* memos live in ``<root>/<path>/<name>/<key>.pkl`` beside the source
  they were made by, ``<name>/func_code.py``;
* ``force_same_code`` pins the stored source: memos survive a change of
  the function's source. Without it a change of source drops them;
* ``force_rerun`` recomputes (and rewrites) the memo of every call;
  ``clear_single`` drops the memo of one argument tuple;
* results are written with ``pickle``, atomically: a temporary file in
  the memo's directory, then ``os.replace``.

The port's jar has its own root, ``<repo>/picklejar_torch/``
(``GPU_SE_TORCH_PICKLEJAR_ROOT`` moves it, ``root=`` pins it): memos are
keyed by name alone, so under the reference's ``picklejar/`` a port
function would be served the reference's memo of the same name. The
root is read when a memo is read or written, and nothing touches the
disk before the first call.
"""
from __future__ import annotations

import hashlib
import inspect
import os
import pickle
import shutil
import tempfile

import numpy as np

global_cache_settings = {
    "force_rerun": False,
    "force_same_code": True,
}

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ROOT_ENV = "GPU_SE_TORCH_PICKLEJAR_ROOT"
CODE_FILE = "func_code.py"


def default_root() -> str:
    """The jar's root: ``$GPU_SE_TORCH_PICKLEJAR_ROOT`` if set, else
    ``<repo>/picklejar_torch``."""
    return os.environ.get(ROOT_ENV, os.path.join(_REPO_ROOT, "picklejar_torch"))


def _canonical(value, out: list) -> None:
    """Append a type-tagged, machine-independent encoding of ``value``."""
    if isinstance(value, np.ndarray):
        arr = np.ascontiguousarray(value)
        out.append(f"ndarray:{arr.dtype.str}:{arr.shape}:".encode())
        out.append(arr.tobytes())
    elif isinstance(value, np.generic):
        out.append(f"np:{value.dtype.str}:".encode())
        out.append(value.tobytes())
    elif value is None or isinstance(value, (bool, int, float, complex, str,
                                             bytes)):
        out.append(f"{type(value).__name__}:{value!r};".encode())
    elif isinstance(value, (tuple, list)):
        out.append(f"{type(value).__name__}[{len(value)}](".encode())
        for v in value:
            _canonical(v, out)
        out.append(b")")
    elif isinstance(value, dict):
        out.append(f"dict[{len(value)}](".encode())
        for k in sorted(value, key=repr):
            _canonical(k, out)
            _canonical(value[k], out)
        out.append(b")")
    else:
        out.append(f"{type(value).__qualname__}:".encode())
        out.append(pickle.dumps(value, protocol=4))


def argument_hash(func, args, kwargs) -> str:
    """The memo key of ``func(*args, **kwargs)``: a hash of the arguments
    bound to ``func``'s signature, defaults applied, so that a call by
    position and one by keyword share a memo."""
    bound = inspect.signature(func).bind(*args, **kwargs)
    bound.apply_defaults()
    parts: list[bytes] = []
    _canonical(list(bound.arguments.items()), parts)
    return hashlib.sha256(b"".join(parts)).hexdigest()[:32]


def function_source(func) -> str:
    """The source of ``func`` (or of its ``__code__``, for wrappers such
    as ``PowerMeasurement``), or its compiled code where there is no
    source file."""
    code = getattr(func, "__code__", None)
    try:
        return inspect.getsource(code if code is not None else func)
    except (OSError, TypeError):
        if code is None:
            return repr(func)
        return f"# no source\n# {code.co_name}: {code.co_code.hex()}\n"


class _Store:
    """Where one function's memos live: ``location`` is ``<root>/<path>``,
    the memos are in ``<location>/<name>/``."""

    def __init__(self, path: str, root, name: str):
        self.path, self.root, self.name = path, root, name

    @property
    def location(self) -> str:
        root = default_root() if self.root is None else self.root
        return os.path.join(root, self.path)

    @property
    def func_dir(self) -> str:
        return os.path.join(self.location, self.name)

    def memo_path(self, key: str) -> str:
        return os.path.join(self.func_dir, f"{key}.pkl")

    def write_atomic(self, path: str, data: bytes) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), prefix=".tmp-")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(data)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def stored_code(self):
        try:
            with open(os.path.join(self.func_dir, CODE_FILE)) as fh:
                return fh.read()
        except FileNotFoundError:
            return None

    def write_code(self, code: str) -> None:
        self.write_atomic(os.path.join(self.func_dir, CODE_FILE),
                          code.encode())

    def clear_all(self) -> None:
        shutil.rmtree(self.func_dir, ignore_errors=True)


class PickleJar:
    """Disk-memoized function with machine-independent identity."""

    def __init__(self, func, location="", cache_settings=None, root=None):
        if cache_settings is None:
            cache_settings = global_cache_settings
        self.cache_settings = cache_settings
        self.func = self.raw = func     # raw: the unmemoized function
        self.__name__ = func.__name__
        self.__doc__ = getattr(func, "__doc__", None)
        self.store_backend = _Store(location, root, func.__name__)

    @staticmethod
    def pickle(path, root=None):
        """Decorator factory: ``@PickleJar.pickle('pf/raw')``. ``root``
        pins the cache directory whatever ``GPU_SE_TORCH_PICKLEJAR_ROOT``
        says."""
        return lambda fun: PickleJar(fun, path, root=root)

    def _check_code(self) -> None:
        """Pin the stored source (``force_same_code``), or drop every memo
        of this function when its source changed."""
        store = self.store_backend
        code = function_source(self.func)
        stored = store.stored_code()
        if stored == code:
            return
        if stored is not None and not self.cache_settings["force_same_code"]:
            store.clear_all()
        store.write_code(code)

    def clear_single(self, *args, **kwargs):
        """Drop the memo for one argument tuple."""
        path = self.store_backend.memo_path(
            argument_hash(self.func, args, kwargs))
        if os.path.exists(path):
            os.remove(path)

    def __call__(self, *args, **kwargs):
        store = self.store_backend
        self._check_code()
        path = store.memo_path(argument_hash(self.func, args, kwargs))
        if not self.cache_settings["force_rerun"] and os.path.exists(path):
            with open(path, "rb") as fh:
                return pickle.load(fh)
        result = self.func(*args, **kwargs)
        store.write_atomic(path, pickle.dumps(result, protocol=4))
        return result
