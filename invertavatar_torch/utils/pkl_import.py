"""Sandboxed reader for the reference's source-embedding pickle checkpoints.

The port's own copy of `invertavatar_tpu/utils/pkl_import.py`. The reference
persists networks with `torch_utils/persistence.py`: each module pickles as
`_reconstruct_persistent_obj(meta)` where `meta` carries the embedded source
code, `init_args` / `init_kwargs` and the module state (the recursive
`nn.Module.__dict__` with `_parameters` / `_buffers` / `_modules`);
`legacy.py` loads `{G, D, G_ema, ...}` from such pickles.

Loading that normally means executing the embedded source. This module runs
a `pickle.Unpickler` whose `find_class` returns inert stubs for every torch
and persistence symbol, rebuilds tensors as numpy arrays from the storage
bytes, and walks the stub module tree into flat `{dotted_name: ndarray}`
state dicts plus `init_kwargs`, in the torch reference's key space, which the
port's modules share. The only real globals it hands out are an exact list of
containers and numpy array constructors; any other numpy global, and any
dotted name, is refused. No code from the checkpoint executes; torch is not
imported here.
"""

from __future__ import annotations

import collections
import io
import pickle
from typing import Any, Dict, Tuple

import numpy as np

_STORAGE_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
    "BFloat16Storage": None,  # handled specially (numpy lacks bf16)
}


class _Storage:
    def __init__(self, dtype_name: str):
        self.dtype_name = dtype_name
        self.data: bytes = b""

    def _load_from_bytes(self, b: bytes):
        # torch.save inside pickles stores storages via BytesIO payloads
        self.data = b


class _TensorStub:
    def __init__(self, storage, storage_offset, size, stride, *_args):
        self.storage = storage
        self.storage_offset = storage_offset
        self.size = tuple(size)
        self.stride = tuple(stride)

    def to_numpy(self) -> np.ndarray:
        dtype = _STORAGE_DTYPES.get(self.storage.dtype_name, np.float32)
        raw = self.storage.data
        if self.storage.dtype_name == "BFloat16Storage":
            u16 = np.frombuffer(raw, dtype=np.uint16)
            flat = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            flat = np.frombuffer(raw, dtype=dtype)
        itemsize = flat.itemsize
        arr = np.lib.stride_tricks.as_strided(
            flat[self.storage_offset :],
            shape=self.size,
            strides=[s * itemsize for s in self.stride],
        )
        return np.array(arr)


def _rebuild_tensor_v2(storage, storage_offset, size, stride, requires_grad=False,
                       backward_hooks=None, metadata=None):
    return _TensorStub(storage, storage_offset, size, stride)


def _rebuild_parameter(tensor, requires_grad=False, backward_hooks=None):
    return tensor


class _StubObject:
    """Inert stand-in for arbitrary classes (torch modules etc.)."""

    _stub_name = "?"

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        self._stub_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_stub_state"] = state


class _PersistentObj(_StubObject):
    """Placeholder produced for `_reconstruct_persistent_obj(meta)`."""

    def __init__(self, meta):
        self.meta = meta


def _make_stub_class(module: str, name: str):
    return type(name, (_StubObject,), {"_stub_name": f"{module}.{name}", "__module__": module})


# the only globals returned as themselves: containers, and the constructors an
# ndarray (protocol 4, and 5's `_frombuffer`), a numpy scalar and a dtype
# pickle with (numpy 1.x names the modules `numpy.core.*`, numpy 2
# `numpy._core.*`)
_ALLOWED = {
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("builtins", "set"): set,
    ("builtins", "frozenset"): frozenset,
    ("builtins", "dict"): dict,
    ("builtins", "list"): list,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
    **{(f"numpy.{core}.{mod}", name): fn
       for core in ("core", "_core")
       for mod, name, fn in (("multiarray", "_reconstruct", np.zeros(0).__reduce__()[0]),
                             ("multiarray", "scalar", np.float32(0).__reduce__()[0]),
                             ("numeric", "_frombuffer", np.zeros(1).__reduce_ex__(5)[0]))},
}


class _SafeUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        if "." in name or module == "numpy" or module.startswith("numpy."):
            # a dotted name walks attributes, and numpy's modules reach `os`,
            # `numpy.load` and `ctypeslib`: either could run code
            raise pickle.UnpicklingError(f"global {module}.{name} is not allowed")
        if name == "_reconstruct_persistent_obj":
            return _PersistentObj
        if name == "_rebuild_tensor_v2":
            return _rebuild_tensor_v2
        if name == "_rebuild_parameter":
            return _rebuild_parameter
        if name == "_rebuild_device_tensor_from_numpy":
            return lambda data, dtype, device, requires_grad: np.asarray(data)
        if module == "torch" and name in _STORAGE_DTYPES:
            # used both as a constructor and as a type marker in persistent ids
            marker = type(name, (), {"__call__": lambda self, *a, **k: _Storage(name)})()
            marker.__name__ = name
            return marker
        if module == "torch.storage" and name == "_load_from_bytes":
            return _torch_load_from_bytes
        return _make_stub_class(module, name)

    def persistent_load(self, pid):
        # torch.save legacy persistent ids: ('storage', storage_type, key, location, numel)
        if isinstance(pid, tuple) and pid and pid[0] == "storage":
            storage_type = pid[1]
            name = getattr(storage_type, "__name__", str(storage_type))
            st = _Storage(name if name in _STORAGE_DTYPES else "FloatStorage")
            self._pending_storages.append((pid[2], st))
            return st
        raise pickle.UnpicklingError(f"unsupported persistent id {pid!r}")


def _torch_load_from_bytes(b: bytes):
    """torch.storage._load_from_bytes: payload is a torch.save-format blob."""
    return _read_torch_save(io.BytesIO(b))


def _read_torch_save(f) -> Any:
    """Minimal reader for the torch.save legacy (non-zip) serialization format,
    as embedded by torch storage pickling: magic, protocol, sys_info, the
    pickled object (with storage persistent ids), then raw storage payloads."""
    up = _SafeUnpickler(f)
    up._pending_storages = []
    magic = up.load()
    protocol = _SafeUnpickler(f).load()
    sysinfo = _SafeUnpickler(f).load()
    main_up = _SafeUnpickler(f)
    main_up._pending_storages = []
    obj = main_up.load()
    # deserialized storage keys
    key_up = _SafeUnpickler(f)
    keys = key_up.load()
    by_key = dict(main_up._pending_storages)
    for key in keys:
        (numel,) = np.frombuffer(f.read(8), dtype=np.int64)
        st = by_key.get(key)
        dtype = _STORAGE_DTYPES.get(st.dtype_name if st else "FloatStorage", np.float32)
        itemsize = 2 if (st and st.dtype_name in ("HalfStorage", "BFloat16Storage")) else np.dtype(dtype).itemsize if dtype else 4
        payload = f.read(int(numel) * itemsize)
        if st is not None:
            st.data = payload
    return obj


def safe_load_pickle(f) -> Any:
    up = _SafeUnpickler(f)
    up._pending_storages = []
    return up.load()


# --------------------------------------------------------------------------- walk


def _walk_module(obj, prefix: str, out: Dict[str, np.ndarray]):
    if isinstance(obj, _PersistentObj):
        state = obj.meta.get("state") if isinstance(obj.meta, dict) else getattr(obj.meta, "state", None)
        _walk_module(state, prefix, out)
        return
    d = obj if isinstance(obj, dict) else getattr(obj, "__dict__", None)
    if d is None:
        return
    for coll in ("_parameters", "_buffers"):
        for name, t in (d.get(coll) or {}).items():
            if t is None:
                continue
            key = f"{prefix}{name}"
            if isinstance(t, _TensorStub):
                out[key] = t.to_numpy()
            elif isinstance(t, np.ndarray):
                out[key] = t
    for name, sub in (d.get("_modules") or {}).items():
        if sub is not None:
            _walk_module(sub, f"{prefix}{name}.", out)


def state_dict_from_stub(obj) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _walk_module(obj, "", out)
    return out


def get_init_kwargs(obj) -> Dict[str, Any]:
    """init_kwargs live in the pickled instance __dict__ (persistence.py:107-108)."""
    if isinstance(obj, _PersistentObj):
        meta = obj.meta
        state = meta.get("state") if isinstance(meta, dict) else getattr(meta, "state", None)
        if isinstance(state, dict):
            return dict(state.get("_init_kwargs") or {})
    return {}


def get_init_args(obj) -> Tuple:
    if isinstance(obj, _PersistentObj):
        meta = obj.meta
        state = meta.get("state") if isinstance(meta, dict) else getattr(meta, "state", None)
        if isinstance(state, dict):
            return tuple(state.get("_init_args") or ())
    return ()


def load_network_pkl(path: str) -> Dict[str, Any]:
    """Read a reference checkpoint pickle -> {name: (state_dict, init_kwargs)}.

    Counterpart of `legacy.load_network_pkl` (legacy.py:24-60) minus the
    torch-module rebuild: returns raw numpy state dicts keyed like the pickle
    ('G', 'D', 'G_ema', 'training_set_kwargs', ...).
    """
    with open(path, "rb") as f:
        data = safe_load_pickle(f)
    out = {}
    for key, val in data.items():
        if isinstance(val, _PersistentObj):
            out[key] = {
                "state_dict": state_dict_from_stub(val),
                "init_kwargs": get_init_kwargs(val),
            }
        else:
            out[key] = val
    return out
