"""JSON (de)serialization for control-plane messages.

Copy of ``dlrover_tpu/common/serialize.py``, its imports the port's.

The reference pickles dataclasses into proto bytes guarded by a restricted
unpickler (``dlrover/python/common/comm.py:77-103`` +
``util/dlrover_pickle.py``).  We deliberately use JSON instead: the control
plane carries small structured metadata only, and JSON removes the
deserialization attack surface entirely while staying debuggable on the wire.
A class registry maps the envelope's ``cls`` name back to the dataclass;
field type hints restore what JSON can't express (bytes via base64, int dict
keys such as ``CommWorld.world``).
"""

import base64
import dataclasses
import json
import typing
from typing import Any, Dict, Optional, Type, TypeVar

T = TypeVar("T")

_MESSAGE_REGISTRY: Dict[str, type] = {}
_TYPE_HINT_CACHE: Dict[type, Dict[str, Any]] = {}


def register_message(cls: type) -> type:
    """Class decorator registering a dataclass for wire (de)serialization."""
    _MESSAGE_REGISTRY[cls.__name__] = cls
    return cls


def registered_class(name: str) -> Optional[type]:
    return _MESSAGE_REGISTRY.get(name)


def _field_hints(cls: type) -> Dict[str, Any]:
    hints = _TYPE_HINT_CACHE.get(cls)
    if hints is None:
        try:
            hints = typing.get_type_hints(cls)
        except Exception:  # noqa: BLE001 - hints are best-effort
            hints = {}
        _TYPE_HINT_CACHE[cls] = hints
    return hints


def _to_jsonable(value: Any) -> Any:
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        payload = {
            f.name: _to_jsonable(getattr(value, f.name))
            for f in dataclasses.fields(value)
        }
        payload["__cls__"] = type(value).__name__
        return payload
    if isinstance(value, dict):
        return {str(k): _to_jsonable(v) for k, v in value.items()}
    if isinstance(value, bool) or value is None:
        return value
    if isinstance(value, (str, int, float)):
        return value
    if isinstance(value, (list, tuple)):
        return [_to_jsonable(v) for v in value]
    if isinstance(value, (bytes, bytearray, memoryview)):
        return {"__bytes__": base64.b64encode(bytes(value)).decode("ascii")}
    if isinstance(value, set):
        return {"__set__": [_to_jsonable(v) for v in value]}
    raise TypeError(f"unserializable control-plane value: {type(value)}")


def _coerce_to_hint(value: Any, hint: Any) -> Any:
    """Restore JSON-lossy structure using the declared field type."""
    if hint is None or value is None:
        return value
    origin = typing.get_origin(hint)
    if origin in (dict, typing.Dict) and isinstance(value, dict):
        args = typing.get_args(hint)
        if args and args[0] is int:
            coerced = {}
            for k, v in value.items():
                try:
                    k = int(k)
                except (TypeError, ValueError):  # graftlint: disable=GL403 (non-int key stays a string by design; nothing failed)
                    pass
                coerced[k] = _coerce_to_hint(v, args[1] if len(args) > 1 else None)
            return coerced
    return value


def _from_jsonable(value: Any) -> Any:
    if isinstance(value, dict):
        if "__bytes__" in value and len(value) == 1:
            return base64.b64decode(value["__bytes__"])
        if "__set__" in value and len(value) == 1:
            return set(_from_jsonable(v) for v in value["__set__"])
        cls_name = value.pop("__cls__", None)
        decoded = {k: _from_jsonable(v) for k, v in value.items()}
        if cls_name:
            cls = registered_class(cls_name)
            if cls is not None:
                field_names = {f.name for f in dataclasses.fields(cls)}
                hints = _field_hints(cls)
                kwargs = {
                    k: _coerce_to_hint(v, hints.get(k))
                    for k, v in decoded.items()
                    if k in field_names
                }
                return cls(**kwargs)
        return decoded
    if isinstance(value, list):
        return [_from_jsonable(v) for v in value]
    return value


def serialize_message(obj: Any) -> bytes:
    return json.dumps(_to_jsonable(obj), separators=(",", ":")).encode("utf-8")


def deserialize_message(data: bytes) -> Any:
    if not data:
        return None
    return _from_jsonable(json.loads(data.decode("utf-8")))


class JsonSerializable:
    """Mixin giving dataclasses to_json/from_json helpers."""

    def to_json(self) -> bytes:
        return serialize_message(self)

    @classmethod
    def from_json(cls: Type[T], data: bytes) -> T:
        obj = deserialize_message(data)
        if not isinstance(obj, cls):
            raise TypeError(
                f"expected {cls.__name__}, decoded {type(obj).__name__}"
            )
        return obj
