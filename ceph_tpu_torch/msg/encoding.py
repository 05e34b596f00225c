"""Versioned wire encoding — the denc/bufferlist analogue.

The reference pins every wire struct with
`ENCODE_START(version, compat, bl)` / `DECODE_START` (ref:
src/include/encoding.h:1 the macro family; src/include/denc.h:51) and
frames messages with a preamble + length-delimited segments + crc32c
epilogues (ref: src/msg/async/frames_v2.h:58-151).  This module is the
TPU framework's equivalent:

* a **TLV value codec** over a closed primitive domain (None/bool/int/
  float/str/bytes/list/tuple/set/dict/ndarray) — decoding can only ever
  construct these types, so network input is data, never code (the
  property `pickle.loads` lacked);
* a **struct registry**: dataclasses (or adapter-wrapped classes)
  register under a stable wire name with `(version, compat)`.  Structs
  encode as `name | u8 v | u8 compat | u32 len | fields...`; a decoder
  that only understands `v' < compat` must reject, while `v > known`
  decodes the known prefix and skips the tail via `len` — exactly the
  ENCODE_START evolution contract, so fields can be appended in later
  versions without flag days;
* **message framing**: magic + flags + length preamble, one payload
  segment, crc32c epilogue (frames_v2 reduced to one segment since we
  don't split front/middle/data).

`tests/fixtures/wire_corpus.json` pins encodings across rounds the way
ceph-object-corpus + ceph-dencoder pin the reference's
(ref: src/tools/ceph-dencoder, qa .../encode-decode-non-regression.sh).

The port's copy of `ceph_tpu.msg.encoding`: the same tags, the same
struct header and the same frame, so a struct registered here under the
reference's wire name, version and field order has the same bytes in
both packages (tests/test_torch_wire.py holds them to the corpus).
"""
from __future__ import annotations

import dataclasses
import struct as _struct
from typing import Any, Callable

import numpy as _np

from ..common.crc32c import crc32c

# ---------------------------------------------------------------- tags

T_NONE = 0
T_TRUE = 1
T_FALSE = 2
T_INT = 3          # zigzag LEB128, arbitrary precision
T_FLOAT = 4        # IEEE754 double, big-endian
T_STR = 5          # LEB128 length + utf-8
T_BYTES = 6        # LEB128 length + raw
T_LIST = 7         # LEB128 count + values
T_TUPLE = 8
T_SET = 9
T_FROZENSET = 10
T_DICT = 11        # LEB128 count + (key, value) pairs
T_NDARRAY = 12     # dtype str, ndim, shape..., raw C-order bytes
T_STRUCT = 13      # name + ENCODE_START(v, compat, len) + field values

#: recursion guard — real payloads are shallow; a hostile frame must
#: not be able to blow the stack
MAX_DEPTH = 64

_U32 = _struct.Struct("!I")
_F64 = _struct.Struct("!d")


class WireError(ValueError):
    """Malformed, incompatible, or unregistered wire data."""


# ------------------------------------------------------------- varints

def _uvarint(n: int, out: bytearray) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(n: int) -> int:
    # arbitrary-precision zigzag (bignums survive the wire)
    return (n << 1) if n >= 0 else ((-n << 1) - 1)


class _Reader:
    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf, pos: int = 0, end: int | None = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > self.end:
            raise WireError("truncated wire data")
        v = memoryview(self.buf)[self.pos:self.pos + n]
        self.pos += n
        return v

    def u8(self) -> int:
        return self.take(1)[0]

    def uvarint(self) -> int:
        shift = n = 0
        while True:
            b = self.u8()
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7
            if shift > 80:          # bignum guard for lengths/counts
                raise WireError("varint too long")


# ------------------------------------------------------------ registry

@dataclasses.dataclass
class _StructInfo:
    name: str
    cls: type
    version: int
    compat: int
    to_fields: Callable[[Any], list]
    from_fields: Callable[[list], Any]
    #: ordered (field name, declared type or None) pairs when the
    #: registration exposes them (dataclass / fields=...); None for
    #: opaque to_fields/from_fields codecs.
    field_schema: tuple | None = None


_by_name: dict[str, _StructInfo] = {}
_by_cls: dict[type, _StructInfo] = {}


def register_struct(cls: type, name: str | None = None,
                    version: int = 1, compat: int = 1,
                    to_fields: Callable | None = None,
                    from_fields: Callable | None = None,
                    fields: tuple | None = None) -> type:
    """Register a wire struct.  Dataclasses get automatic positional
    field lists (append-only evolution: bump `version` when adding
    fields, keep `compat` at the oldest decoder that still works —
    ref: encoding.h ENCODE_START semantics).  Non-dataclass types can
    pass `fields=(attr, ...)`: values are read with getattr and
    restored with setattr onto a no-arg-constructed instance (missing
    trailing fields keep the constructor's defaults)."""
    name = name or cls.__name__
    field_schema: tuple | None = None
    if to_fields is None and fields is not None:
        field_schema = tuple((n, None, False) for n in fields)

        def to_fields(obj, _flds=fields):
            return [getattr(obj, n) for n in _flds]

        def from_fields(vals, _cls=cls, _flds=fields):
            obj = _cls()
            for n, v in zip(_flds, vals):
                setattr(obj, n, v)
            return obj

    if to_fields is None:
        if not dataclasses.is_dataclass(cls):
            raise TypeError(f"{cls} needs explicit to_fields/from_fields")
        dcf = [f for f in dataclasses.fields(cls) if f.init]
        flds = [f.name for f in dcf]
        # a field declared by ANY base keeps the base's wire position
        # even when a subclass redeclares it (dataclass field-order
        # rule) — mark those inherited
        base_ann: set = set()
        for b in cls.__mro__[1:]:
            base_ann.update(vars(b).get("__annotations__", {}))
        field_schema = tuple(
            (f.name, f.type if isinstance(f.type, str)
             else getattr(f.type, "__name__", repr(f.type)),
             f.name in base_ann)
            for f in dcf)

        def to_fields(obj, _flds=flds):
            return [getattr(obj, n) for n in _flds]

        def from_fields(vals, _cls=cls, _flds=flds):
            return _cls(**dict(zip(_flds, vals)))

    info = _StructInfo(name, cls, version, compat, to_fields, from_fields,
                       field_schema)
    if name in _by_name and _by_name[name].cls is not cls:
        raise ValueError(f"wire name {name!r} already registered")
    _by_name[name] = info
    _by_cls[cls] = info
    return cls


def wire_struct(name: str | None = None, version: int = 1,
                compat: int = 1):
    """Decorator form of register_struct for dataclasses."""
    def deco(cls):
        return register_struct(cls, name, version, compat)
    return deco


def registered_types() -> dict[str, type]:
    return {n: i.cls for n, i in sorted(_by_name.items())}


def registered_schema() -> dict[str, dict]:
    """Wire schema of every registered struct — name, (version,
    compat), and the ordered field list where the registration exposes
    one (the same view as the reference's, so the two can be
    compared)."""
    out: dict[str, dict] = {}
    for n, i in sorted(_by_name.items()):
        out[n] = {
            "version": i.version,
            "compat": i.compat,
            "fields": None if i.field_schema is None else
            [{"name": fn, "type": ft, "inherited": inh}
             for fn, ft, inh in i.field_schema],
        }
    return out


def ensure_registered() -> None:
    """Import every module of the port that registers wire structs
    (idempotent).  Decoders of PERSISTED data call this first so
    decoding never depends on what the caller happened to import."""
    from ..osd import pg_types as _pt         # noqa: F401
    from ..osd import types as _ot            # noqa: F401
    from ..store import memstore as _ms       # noqa: F401
    from ..store import objectstore as _os    # noqa: F401
    from . import messages as _mm             # noqa: F401


# -------------------------------------------------------------- encode

def _encode_value(obj: Any, out: bytearray, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise WireError("structure too deep")
    if obj is None:
        out.append(T_NONE)
    elif obj is True:
        out.append(T_TRUE)
    elif obj is False:
        out.append(T_FALSE)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        out.append(T_INT)
        _uvarint(_zigzag(obj), out)
    elif isinstance(obj, float):
        out.append(T_FLOAT)
        out += _F64.pack(obj)
    elif isinstance(obj, str):
        b = obj.encode()
        out.append(T_STR)
        _uvarint(len(b), out)
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(T_BYTES)
        _uvarint(len(b), out)
        out += b
    elif isinstance(obj, _np.ndarray):
        if obj.dtype.hasobject:
            raise WireError("object-dtype ndarray is not wire-safe")
        arr = _np.ascontiguousarray(obj)
        dt = arr.dtype.str.encode()
        out.append(T_NDARRAY)
        _uvarint(len(dt), out)
        out += dt
        _uvarint(arr.ndim, out)
        for d in arr.shape:
            _uvarint(d, out)
        raw = arr.tobytes()
        _uvarint(len(raw), out)
        out += raw
    elif isinstance(obj, (_np.integer,)):
        out.append(T_INT)
        _uvarint(_zigzag(int(obj)), out)
    elif isinstance(obj, (_np.floating,)):
        out.append(T_FLOAT)
        out += _F64.pack(float(obj))
    elif type(obj) in (list, tuple, set, frozenset):
        out.append({list: T_LIST, tuple: T_TUPLE, set: T_SET,
                    frozenset: T_FROZENSET}[type(obj)])
        items = sorted(obj, key=repr) if isinstance(obj, (set, frozenset)) \
            else obj
        _uvarint(len(items), out)
        for v in items:
            _encode_value(v, out, depth + 1)
    elif type(obj) is dict:
        out.append(T_DICT)
        _uvarint(len(obj), out)
        for k, v in obj.items():
            _encode_value(k, out, depth + 1)
            _encode_value(v, out, depth + 1)
    else:
        info = _by_cls.get(type(obj))
        if info is None:
            raise WireError(
                f"type {type(obj).__module__}.{type(obj).__name__} is "
                "not wire-registered (register_struct/wire_struct)")
        _encode_struct(info, obj, out, depth)


def _encode_struct(info: _StructInfo, obj: Any, out: bytearray,
                   depth: int) -> None:
    nb = info.name.encode()
    out.append(T_STRUCT)
    _uvarint(len(nb), out)
    out += nb
    # ENCODE_START(v, compat, bl) (ref: encoding.h)
    out.append(info.version)
    out.append(info.compat)
    body = bytearray()
    fields = info.to_fields(obj)
    _uvarint(len(fields), body)
    for v in fields:
        _encode_value(v, body, depth + 1)
    out += _U32.pack(len(body))
    out += body


def encode(obj: Any) -> bytes:
    """Encode one value (any TLV primitive or registered struct)."""
    out = bytearray()
    _encode_value(obj, out, 0)
    return bytes(out)


# -------------------------------------------------------------- decode

def _decode_value(r: _Reader, depth: int) -> Any:
    if depth > MAX_DEPTH:
        raise WireError("structure too deep")
    tag = r.u8()
    if tag == T_NONE:
        return None
    if tag == T_TRUE:
        return True
    if tag == T_FALSE:
        return False
    if tag == T_INT:
        return _dec_int(r)
    if tag == T_FLOAT:
        return _F64.unpack(r.take(8))[0]
    if tag == T_STR:
        return bytes(r.take(r.uvarint())).decode()
    if tag == T_BYTES:
        return bytes(r.take(r.uvarint()))
    if tag == T_NDARRAY:
        dt = bytes(r.take(r.uvarint())).decode()
        ndim = r.uvarint()
        if ndim > 32:
            raise WireError("ndarray rank too large")
        shape = tuple(r.uvarint() for _ in range(ndim))
        raw = r.take(r.uvarint())
        try:
            dtype = _np.dtype(dt)
        except TypeError as ex:
            raise WireError(f"bad dtype {dt!r}") from ex
        if dtype.hasobject:
            raise WireError("object-dtype ndarray is not wire-safe")
        arr = _np.frombuffer(raw, dtype=dtype)
        try:
            return arr.reshape(shape).copy()
        except ValueError as ex:
            raise WireError(str(ex)) from ex
    if tag in (T_LIST, T_TUPLE, T_SET, T_FROZENSET):
        n = r.uvarint()
        vals = [_decode_value(r, depth + 1) for _ in range(n)]
        return {T_LIST: list, T_TUPLE: tuple, T_SET: set,
                T_FROZENSET: frozenset}[tag](vals)
    if tag == T_DICT:
        n = r.uvarint()
        out = {}
        for _ in range(n):
            k = _decode_value(r, depth + 1)
            out[k] = _decode_value(r, depth + 1)
        return out
    if tag == T_STRUCT:
        return _decode_struct(r, depth)
    raise WireError(f"unknown wire tag {tag}")


def _dec_int(r: _Reader) -> int:
    # arbitrary-precision LEB128 zigzag (mirror of _svarint/_zigzag)
    shift = n = 0
    while True:
        b = r.u8()
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
        if shift > 4096:
            raise WireError("int too long")
    return (n >> 1) if not n & 1 else -((n + 1) >> 1)


def _decode_struct(r: _Reader, depth: int) -> Any:
    name = bytes(r.take(r.uvarint())).decode()
    v = r.u8()
    compat = r.u8()
    (length,) = _U32.unpack(r.take(4))
    body = _Reader(r.buf, r.pos, r.pos + length)
    if body.end > r.end:
        raise WireError("struct overruns frame")
    r.pos += length
    info = _by_name.get(name)
    if info is None:
        raise WireError(f"unknown wire struct {name!r}")
    # DECODE_START compat contract (ref: encoding.h): a struct whose
    # compat is newer than the version we implement cannot be decoded
    if compat > info.version:
        raise WireError(
            f"{name} wire v{v} requires decoder >= v{compat}, "
            f"we implement v{info.version}")
    n = body.uvarint()
    vals = [_decode_value(body, depth + 1) for _ in range(n)]
    # v > ours: trailing fields already skipped via `length`;
    # v < ours: missing fields fall back to dataclass defaults
    try:
        return info.from_fields(vals)
    except TypeError as ex:
        raise WireError(f"{name}: {ex}") from ex


def decode(data) -> Any:
    r = _Reader(data)
    val = _decode_value(r, 0)
    if r.pos != r.end:
        raise WireError(f"{r.end - r.pos} trailing bytes")
    return val


# ----------------------------------------------------- message framing

#: frame magic (the banner/preamble marker; ref: frames_v2.h preamble)
MAGIC = b"CTv2"
FLAG_NONE = 0

_PREAMBLE = _struct.Struct("!4sBI")     # magic, flags, payload len


def encode_message(msg: Any) -> bytes:
    """Frame one message: preamble + struct payload + crc32c epilogue
    (ref: frames_v2.h:58-151, reduced to a single segment)."""
    info = _by_cls.get(type(msg))
    if info is None:
        raise WireError(f"message type {type(msg).__name__} is not "
                        "wire-registered")
    payload = bytearray()
    _encode_struct(info, msg, payload, 0)
    crc = crc32c(0, bytes(payload))
    return _PREAMBLE.pack(MAGIC, FLAG_NONE, len(payload)) + \
        bytes(payload) + _U32.pack(crc)


def decode_message(frame) -> Any:
    r = _Reader(frame)
    magic, _flags, n = _PREAMBLE.unpack(r.take(_PREAMBLE.size))
    if magic != MAGIC:
        raise WireError("bad frame magic")
    payload = r.take(n)
    (crc,) = _U32.unpack(r.take(4))
    if r.pos != r.end:
        raise WireError("trailing bytes after frame")
    if crc32c(0, bytes(payload)) != crc:
        raise WireError("frame crc mismatch")
    body = _Reader(payload)
    if body.u8() != T_STRUCT:
        raise WireError("frame payload is not a struct")
    msg = _decode_struct(body, 0)
    if body.pos != body.end:
        raise WireError("trailing bytes in payload")
    return msg
