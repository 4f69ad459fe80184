"""
A parquet writer of the port's own, for what the client's disk forwarder
writes (client/forwarders.py): the JAX forwarder calls
``DataFrame.to_parquet``, and the card's machine has no pyarrow.

:func:`write_frame` writes one file: one row group, one PLAIN, uncompressed
data page (v1) a column, float64 columns and UTF-8 string columns, each
optional (a NaN or None is a null; a column of nulls alone is pyarrow's
Null column), and the index as an INT64
``TIMESTAMP(MICROS, isAdjustedToUTC)`` column ``__index_level_0__``, with
the ``pandas`` key-value metadata that makes ``pd.read_parquet`` restore it
as the frame's index, and the ``ARROW:schema`` key (the Arrow IPC schema,
a flatbuffer written by hand, :class:`_FlatBuffer`) that gives the index
its time zone back, as pyarrow writes them. Microseconds, not nanoseconds:
the port's times are Python datetimes, and pandas reads the JAX frames'
ISO-parsed index at that unit too. The footer is Thrift's compact protocol,
written by hand (:func:`_struct`).

It is a writer only: reading parquet stays refused everywhere in the port
(dataset/data_provider.py, server/views.py). :func:`footer_rows` reads back
no more than the row count a footer states.
"""

import base64
import json
import math
import struct
from datetime import datetime, timedelta, timezone
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["write_frame", "footer_rows", "INDEX_COLUMN"]

INDEX_COLUMN = "__index_level_0__"
MAGIC = b"PAR1"
_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)

# parquet.thrift's enums
_INT32, _INT64, _DOUBLE, _BYTE_ARRAY = 1, 2, 5, 6
_OPTIONAL = 1
_UTF8, _TIMESTAMP_MICROS = 0, 10
_PLAIN, _RLE = 0, 3
_DATA_PAGE = 0
_UNCOMPRESSED = 0

# Thrift compact protocol's field types
_CT = {"i32": 5, "i64": 6, "bin": 8, "list": 9, "struct": 12}
_CT_TRUE, _CT_FALSE = 1, 2


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _value(kind, value) -> bytes:
    if kind in ("i32", "i64"):
        return _varint(_zigzag(value))
    if kind == "bin":
        data = value.encode() if isinstance(value, str) else value
        return _varint(len(data)) + data
    if kind == "struct":
        return _struct(value)
    _, element = kind  # ("list", element kind)
    size = len(value)
    head = bytes([size << 4 | _CT[element]]) if size < 15 else (
        bytes([0xF0 | _CT[element]]) + _varint(size))
    return head + b"".join(_value(element, item) for item in value)


def _struct(fields) -> bytes:
    """A Thrift struct in the compact protocol: ``fields`` is a list of
    ``(field id, kind, value)``, kind ``"i32"``, ``"i64"``, ``"bin"``,
    ``"bool"``, ``"struct"`` (value: its fields) or ``("list", element kind)``;
    a None value is left out."""
    out, last = bytearray(), 0
    for fid, kind, value in fields:
        if value is None:
            continue
        ctype = ((_CT_TRUE if value else _CT_FALSE) if kind == "bool"
                 else _CT["list" if isinstance(kind, tuple) else kind])
        delta = fid - last
        if 0 < delta <= 15:
            out.append(delta << 4 | ctype)
        else:
            out.append(ctype)
            out += _varint(_zigzag(fid))
        if kind != "bool":
            out += _value(kind, value)
        last = fid
    out.append(0)
    return bytes(out)


def _definition_levels(defined: Sequence[bool]) -> bytes:
    """The RLE/bit-packed hybrid of 1-bit definition levels, one bit-packed
    run, behind its 4-byte length (a v1 data page's layout)."""
    groups = math.ceil(len(defined) / 8)
    bits = np.zeros(groups * 8, np.uint8)
    bits[:len(defined)] = defined
    run = _varint(groups << 1 | 1) + np.packbits(bits, bitorder="little").tobytes()
    return struct.pack("<I", len(run)) + run


def epoch_micros(ts: datetime) -> int:
    """Microseconds from the Unix epoch to the tz-aware ``ts``."""
    return (ts - _EPOCH) // timedelta(microseconds=1)


def _tz_name(ts: datetime) -> str:
    """pandas' name of the index's time zone: ``UTC`` or ``+HH:MM``."""
    offset = ts.utcoffset()
    if not offset:
        return "UTC"
    minutes = int(offset.total_seconds()) // 60
    return f"{'+' if minutes >= 0 else '-'}{abs(minutes) // 60:02d}:{abs(minutes) % 60:02d}"


def _column(name: str, values) -> Tuple[list, bytes, int, dict]:
    """(schema element, page data, parquet type, pandas column metadata) of
    one float64 (an array) or string (a list) column. A column without a
    value is written as pyarrow writes pandas' column of None: INT32 of the
    logical type Null."""
    if isinstance(values, np.ndarray):
        values = np.asarray(values, np.float64)
        defined = ~np.isnan(values)
        data = values[defined].astype("<f8").tobytes()
        physical, converted, logical, types = _DOUBLE, None, None, ("float64", "float64")
    else:
        defined = np.array([v is not None for v in values], bool)
        data = b"".join(struct.pack("<I", len(b)) + b
                        for b in (v.encode() for v in values if v is not None))
        physical, converted, logical, types = (_BYTE_ARRAY, _UTF8, [(1, "struct", [])],
                                               ("unicode", "object"))
    if len(defined) and not defined.any():
        physical, converted, logical, types = _INT32, None, [(11, "struct", [])], ("empty",
                                                                                  "object")
    schema = [(1, "i32", physical), (3, "i32", _OPTIONAL), (4, "bin", name),
              (6, "i32", converted), (10, "struct", logical)]
    meta = {"name": name, "field_name": name, "pandas_type": types[0], "numpy_type": types[1],
            "metadata": None}
    return schema, _definition_levels(defined) + data, physical, meta


# the Arrow IPC schema (Schema.fbs, Message.fbs) that pyarrow stores under
# ARROW:schema: the index's time zone, which parquet's UTC-adjusted
# timestamp does not keep, comes back from it
_ARROW_TYPES = {"float64": (3, [(0, "i16", 2)]),  # FloatingPoint, DOUBLE
                "unicode": (5, []),  # Utf8
                "empty": (1, []),  # Null
                "datetimetz": (10, None)}  # Timestamp, MICROSECOND and its zone


class _FlatBuffer:
    """A flatbuffer written front to back: each table's vtable, then the
    table, then what it points to, so that every offset points forward."""

    _SIZES = {"u8": 1, "bool": 1, "i16": 2, "offset": 4}

    def __init__(self):
        self.buf = bytearray()

    def _align(self, n: int) -> None:
        self.buf += bytes(-len(self.buf) % n)

    def _patch(self, at: int, target: int) -> None:
        self.buf[at:at + 4] = struct.pack("<I", target - at)

    def string(self, text: str) -> int:
        self._align(4)
        at = len(self.buf)
        data = text.encode()
        self.buf += struct.pack("<I", len(data)) + data + b"\0"
        return at

    def vector(self, items) -> int:
        """A vector of tables (or strings): ``items`` are writers."""
        self._align(4)
        at = len(self.buf)
        self.buf += struct.pack("<I", len(items)) + bytes(4 * len(items))
        for i, write in enumerate(items):
            self._patch(at + 4 + 4 * i, write())
        return at

    def table(self, fields) -> int:
        """``fields``: ``(id, kind, value)``, kind ``u8``, ``bool``, ``i16``
        or ``offset`` (value: a writer returning the child's position)."""
        order = sorted(fields, key=lambda f: -self._SIZES[f[1]])
        slots, size = {}, 4
        for fid, kind, _ in order:
            width = self._SIZES[kind]
            size += -size % width
            slots[fid] = size
            size += width
        size += -size % 4
        n = max([fid for fid, _, _ in fields], default=-1) + 1
        self._align(2)
        vtable = len(self.buf)
        self.buf += struct.pack(f"<{2 + n}H", 4 + 2 * n, size,
                                *(slots.get(fid, 0) for fid in range(n)))
        self._align(4)
        at = len(self.buf)
        body = bytearray(size)
        body[:4] = struct.pack("<i", at - vtable)
        for fid, kind, value in fields:
            if kind != "offset":
                fmt = {"u8": "<B", "bool": "<B", "i16": "<h"}[kind]
                body[slots[fid]:slots[fid] + self._SIZES[kind]] = struct.pack(fmt, value)
        self.buf += body
        for fid, kind, value in fields:
            if kind == "offset":
                self._patch(at + slots[fid], value())
        return at


def _arrow_schema(columns: List[dict], metadata: str) -> str:
    """The base64 of the encapsulated IPC message of the Arrow schema of
    ``columns`` (their pandas metadata) with the ``pandas`` key."""
    fb = _FlatBuffer()

    def field(meta):
        kind, props = _ARROW_TYPES[meta["pandas_type"]]
        if props is None:
            zone = meta["metadata"]["timezone"]
            props = [(0, "i16", 2), (1, "offset", lambda: fb.string(zone))]
        return lambda: fb.table([
            (0, "offset", lambda: fb.string(meta["field_name"])), (1, "bool", 1),
            (2, "u8", kind), (3, "offset", lambda: fb.table(props)),
            (5, "offset", lambda: fb.vector([]))])

    pandas = lambda: fb.table([(0, "offset", lambda: fb.string("pandas")),  # noqa: E731
                               (1, "offset", lambda: fb.string(metadata))])
    schema = lambda: fb.table([  # noqa: E731
        (1, "offset", lambda: fb.vector([field(meta) for meta in columns])),
        (2, "offset", lambda: fb.vector([pandas]))])
    fb.buf += bytes(4)
    fb._patch(0, fb.table([(0, "i16", 4), (1, "u8", 1), (2, "offset", schema)]))  # V5, Schema
    fb._align(8)
    return base64.b64encode(b"\xff\xff\xff\xff" + struct.pack("<i", len(fb.buf))
                            + bytes(fb.buf)).decode()


def write_frame(path: str, columns: Sequence[Tuple[str, object]], index: List[datetime],
                creator: str = "gordo_tpu_torch") -> int:
    """Write ``columns`` (``(name, values)``: a float64 array, NaN for null,
    or a list of str or None) over the time ``index`` (tz-aware datetimes)
    as one parquet file at ``path``; returns the bytes written."""
    n = len(index)
    if any(not isinstance(ts, datetime) or ts.tzinfo is None for ts in index):
        raise ValueError("the index must be tz-aware datetimes")
    for name, values in columns:
        if len(values) != n:
            raise ValueError(f"column {name!r} has {len(values)} values for {n} rows")
    built = [_column(name, values) for name, values in columns]
    micros = np.array([epoch_micros(ts) for ts in index], "<i8")
    tz = _tz_name(index[0]) if n else "UTC"
    built.append((
        [(1, "i32", _INT64), (3, "i32", _OPTIONAL), (4, "bin", INDEX_COLUMN),
         (6, "i32", _TIMESTAMP_MICROS),
         (10, "struct", [(8, "struct", [(1, "bool", True), (2, "struct", [(2, "struct", [])])])])],
        _definition_levels([True] * n) + micros.tobytes(), _INT64,
        {"name": None, "field_name": INDEX_COLUMN, "pandas_type": "datetimetz",
         "numpy_type": "datetime64[us]", "metadata": {"timezone": tz}}))
    body, chunks, total = bytearray(MAGIC), [], 0
    for schema, page, physical, meta in built:
        header = _struct([(1, "i32", _DATA_PAGE), (2, "i32", len(page)), (3, "i32", len(page)),
                          (5, "struct", [(1, "i32", n), (2, "i32", _PLAIN), (3, "i32", _RLE),
                                         (4, "i32", _RLE)])])
        offset, total = len(body), total + len(header) + len(page)
        body += header + page
        chunks.append([(2, "i64", offset), (3, "struct", [
            (1, "i32", physical), (2, ("list", "i32"), [_PLAIN, _RLE]),
            (3, ("list", "bin"), [meta["field_name"]]), (4, "i32", _UNCOMPRESSED), (5, "i64", n),
            (6, "i64", len(header) + len(page)), (7, "i64", len(header) + len(page)),
            (9, "i64", offset)])])
    pandas = {"index_columns": [INDEX_COLUMN],
              "column_indexes": [{"name": None, "field_name": None, "pandas_type": "unicode",
                                  "numpy_type": "object", "metadata": {"encoding": "UTF-8"}}],
              "columns": [meta for *_, meta in built],
              "creator": {"library": creator}}
    text = json.dumps(pandas)
    footer = _struct([
        (1, "i32", 2),
        (2, ("list", "struct"), [[(4, "bin", "schema"), (5, "i32", len(built))]]
         + [schema for schema, *_ in built]),
        (3, "i64", n),
        (4, ("list", "struct"), [[(1, ("list", "struct"), chunks), (2, "i64", total),
                                  (3, "i64", n)]]),
        (5, ("list", "struct"), [
            [(1, "bin", "ARROW:schema"), (2, "bin", _arrow_schema(pandas["columns"], text))],
            [(1, "bin", "pandas"), (2, "bin", text)]]),
        (6, "bin", creator)])
    body += footer + struct.pack("<I", len(footer)) + MAGIC
    with open(path, "wb") as fh:
        fh.write(body)
    return len(body)


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = value = 0
    while True:
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, pos


def _read(data: bytes, pos: int, ctype: int):
    """(value, next position) of one compact-protocol value of type ``ctype``;
    a struct reads as ``{field id: value}``, a list as a list."""
    if ctype in (_CT_TRUE, _CT_FALSE):
        return ctype == _CT_TRUE, pos
    if ctype == 3:
        return data[pos], pos + 1
    if ctype in (4, 5, 6):
        raw, pos = _read_varint(data, pos)
        return (raw >> 1) ^ -(raw & 1), pos
    if ctype == 7:
        return struct.unpack_from("<d", data, pos)[0], pos + 8
    if ctype == _CT["bin"]:
        size, pos = _read_varint(data, pos)
        return data[pos:pos + size], pos + size
    if ctype == _CT["list"]:
        size, etype = data[pos] >> 4, data[pos] & 0x0F
        pos += 1
        if size == 15:
            size, pos = _read_varint(data, pos)
        items = []
        for _ in range(size):
            item, pos = _read(data, pos, etype)
            items.append(item)
        return items, pos
    if ctype == _CT["struct"]:
        fields, last = {}, 0
        while data[pos]:
            delta, ftype = data[pos] >> 4, data[pos] & 0x0F
            pos += 1
            if delta:
                fid = last + delta
            else:
                raw, pos = _read_varint(data, pos)
                fid = (raw >> 1) ^ -(raw & 1)
            fields[fid], pos = _read(data, pos, ftype)
            last = fid
        return fields, pos + 1
    raise ValueError(f"compact protocol type {ctype} is not read here")


def footer_rows(path: str) -> int:
    """The row count the footer of the parquet file at ``path`` states."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ValueError(f"{path} is not a parquet file")
    size = struct.unpack_from("<I", data, len(data) - 8)[0]
    meta, _ = _read(data, len(data) - 8 - size, _CT["struct"])
    return meta[3]
