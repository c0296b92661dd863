"""Columnar substrate: host tables and fixed-capacity device tables.

Device data model (analog of the reference's Arrow RecordBatch layer,
cf. reference `src/api_utils.rs`, `src/utils/static_table.rs`):

  * A column is `(values, validity)` — two dense arrays. No offsets/varlen on
    device: strings are dictionary-encoded to int32 codes at ingest, the
    dictionary stays on the host.
  * A `DeviceTable` has a STATIC capacity (power of two) and a traced
    `num_rows` scalar. Rows past `num_rows` are padding. Every kernel masks by
    `iota < num_rows`. This is what makes the whole engine jit-compatible:
    data-dependent row counts never change array shapes.
  * `DeviceTable` is a pytree: arrays + num_rows are leaves; the schema
    (including string dictionaries, hashed by identity) is static aux data, so
    jit caches per (schema, capacity) signature.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def round_capacity(n: int, minimum: int = 128) -> int:
    """Round a row count up to the next power of two (bounded recompiles).

    Above 64M rows, round to the next multiple of 4M instead: a power-of-2
    capacity wastes up to 2x at exactly the scale where HBM is the binding
    constraint (SF100 orders: 150M rows -> 268M pow2 capacity; its [5, cap]
    pack alone is 8 GB padded). 4M steps keep the distinct-shape count
    bounded (compile cache) while capping padding waste at ~3%."""
    n = max(int(n), minimum)
    if n > (1 << 26):
        step = 1 << 22
        return -(-n // step) * step
    return 1 << (n - 1).bit_length()


class Kind(enum.Enum):
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    BOOL = "bool"
    DATE32 = "date32"      # days since 1970-01-01, int32 on device
    STRING = "string"      # dictionary codes, int32 on device
    DECIMAL = "decimal"    # fixed-point int64 (value * 10**scale)


_DEVICE_DTYPE = {
    Kind.INT32: jnp.int32,
    Kind.INT64: jnp.int64,
    Kind.FLOAT32: jnp.float32,
    Kind.FLOAT64: jnp.float64,
    Kind.BOOL: jnp.bool_,
    Kind.DATE32: jnp.int32,
    Kind.STRING: jnp.int32,
    Kind.DECIMAL: jnp.int64,
}


@dataclass(frozen=True)
class DType:
    kind: Kind
    scale: int = 0  # decimal scale only

    @property
    def device_dtype(self):
        return _DEVICE_DTYPE[self.kind]

    def __repr__(self):
        if self.kind is Kind.DECIMAL:
            return f"decimal(.,{self.scale})"
        return self.kind.value


INT32 = DType(Kind.INT32)
INT64 = DType(Kind.INT64)
FLOAT32 = DType(Kind.FLOAT32)
FLOAT64 = DType(Kind.FLOAT64)
BOOL = DType(Kind.BOOL)
DATE32 = DType(Kind.DATE32)
STRING = DType(Kind.STRING)


def DECIMAL(scale: int) -> DType:
    return DType(Kind.DECIMAL, scale)


class Dictionary:
    """String dictionary (host side). Hash/eq by identity: the same ingested
    table always presents the same object, so jit caches are stable."""

    __slots__ = ("values", "_index")

    def __init__(self, values: np.ndarray):
        self.values = np.asarray(values, dtype=object)
        self._index: Optional[dict] = None

    def index(self) -> dict:
        if self._index is None:
            self._index = {v: i for i, v in enumerate(self.values)}
        return self._index

    def code_of(self, s) -> int:
        """Code of string s, or -1 if absent."""
        return self.index().get(s, -1)

    def __len__(self):
        return len(self.values)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        return f"Dictionary(n={len(self.values)}, id={id(self):#x})"


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DType
    nullable: bool = True
    dictionary: Optional[Dictionary] = None

    def with_name(self, name: str) -> "Field":
        return replace(self, name=name)


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __init__(self, fields: Sequence[Field]):
        object.__setattr__(self, "fields", tuple(fields))
        names = [f.name for f in self.fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in schema: {names}")

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(f"no column {name!r}; have {self.names}")

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    def __len__(self):
        return len(self.fields)


# ---------------------------------------------------------------------------
# Host table
# ---------------------------------------------------------------------------

_HOST_DTYPE = {
    Kind.INT32: np.int32,
    Kind.INT64: np.int64,
    Kind.FLOAT32: np.float32,
    Kind.FLOAT64: np.float64,
    Kind.BOOL: np.bool_,
    Kind.DATE32: np.int32,
    Kind.STRING: np.int32,
    Kind.DECIMAL: np.int64,
}

_EPOCH = np.datetime64("1970-01-01", "D")


def date32_of(s: str) -> int:
    """'1994-03-15' -> days since epoch."""
    return int((np.datetime64(s, "D") - _EPOCH).astype(np.int64))


class HostTable:
    """Host-resident columnar table: numpy values + validity per column."""

    def __init__(self, schema: Schema, columns: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 num_rows: int):
        self.schema = schema
        self.columns = columns
        self.num_rows = int(num_rows)

    @staticmethod
    def from_pydict(data: Dict[str, list], dtypes: Optional[Dict[str, DType]] = None
                    ) -> "HostTable":
        """Build from python lists; None means null. Strings dict-encode."""
        dtypes = dtypes or {}
        fields, columns = [], {}
        num_rows = None
        for name, vals in data.items():
            vals = list(vals)
            if num_rows is None:
                num_rows = len(vals)
            elif num_rows != len(vals):
                raise ValueError("ragged columns")
            validity = np.array([v is not None for v in vals], dtype=np.bool_)
            dt = dtypes.get(name)
            dictionary = None
            nonnull = [v for v in vals if v is not None]
            if dt is None:
                if any(isinstance(v, str) for v in nonnull):
                    dt = STRING
                elif any(isinstance(v, float) for v in nonnull):
                    dt = FLOAT64
                elif all(isinstance(v, (bool, np.bool_)) for v in nonnull) and nonnull:
                    dt = BOOL
                else:
                    dt = INT32
                    if any(abs(int(v)) > 2**31 - 1 for v in nonnull):
                        dt = INT64
            if dt.kind is Kind.STRING:
                uniq = sorted({v for v in nonnull})
                dictionary = Dictionary(np.array(uniq, dtype=object))
                idx = dictionary.index()
                values = np.array([idx[v] if v is not None else 0 for v in vals],
                                  dtype=np.int32)
            else:
                np_dt = _HOST_DTYPE[dt.kind]
                fill = np_dt(0)
                if dt.kind is Kind.DECIMAL:
                    scale = 10 ** dt.scale
                    values = np.array(
                        [np.int64(round(float(v) * scale)) if v is not None else fill
                         for v in vals], dtype=np_dt)
                elif dt.kind is Kind.DATE32:
                    values = np.array(
                        [date32_of(v) if isinstance(v, str) else (v if v is not None else 0)
                         for v in vals], dtype=np_dt)
                else:
                    values = np.array([v if v is not None else fill for v in vals],
                                      dtype=np_dt)
            fields.append(Field(name, dt, nullable=not validity.all(),
                                dictionary=dictionary))
            columns[name] = (values, validity)
        return HostTable(Schema(fields), columns, num_rows or 0)

    @staticmethod
    def from_numpy(data: Dict[str, np.ndarray],
                   dtypes: Optional[Dict[str, DType]] = None,
                   dictionaries: Optional[Dict[str, Dictionary]] = None,
                   validity: Optional[Dict[str, np.ndarray]] = None) -> "HostTable":
        dtypes = dtypes or {}
        dictionaries = dictionaries or {}
        validity = validity or {}
        fields, columns = [], {}
        num_rows = None
        for name, arr in data.items():
            arr = np.asarray(arr)
            if num_rows is None:
                num_rows = len(arr)
            dt = dtypes.get(name)
            if dt is None:
                dt = {np.dtype(np.int32): INT32, np.dtype(np.int64): INT64,
                      np.dtype(np.float32): FLOAT32, np.dtype(np.float64): FLOAT64,
                      np.dtype(np.bool_): BOOL}[arr.dtype]
            valid = validity.get(name)
            if valid is None:
                valid = np.ones(len(arr), dtype=np.bool_)
            fields.append(Field(name, dt, nullable=not valid.all(),
                                dictionary=dictionaries.get(name)))
            columns[name] = (arr.astype(_HOST_DTYPE[dt.kind], copy=False), valid)
        return HostTable(Schema(fields), columns, num_rows or 0)

    def to_device(self, capacity: Optional[int] = None) -> "DeviceTable":
        cap = capacity or round_capacity(self.num_rows)
        if cap < self.num_rows:
            raise ValueError("capacity < num_rows")
        cols = {}
        for f in self.schema.fields:
            v, valid = self.columns[f.name]
            pad = cap - len(v)
            if pad:
                v = np.concatenate([v, np.zeros(pad, dtype=v.dtype)])
                valid = np.concatenate([valid, np.zeros(pad, dtype=np.bool_)])
            cols[f.name] = (jnp.asarray(v), jnp.asarray(valid))
        return DeviceTable(self.schema, cols, jnp.int32(self.num_rows))

    def to_pylist(self) -> List[dict]:
        out = []
        for i in range(self.num_rows):
            row = {}
            for f in self.schema.fields:
                v, valid = self.columns[f.name]
                if not valid[i]:
                    row[f.name] = None
                elif f.dtype.kind is Kind.STRING:
                    row[f.name] = f.dictionary.values[int(v[i])]
                elif f.dtype.kind is Kind.DECIMAL:
                    row[f.name] = int(v[i]) / (10 ** f.dtype.scale)
                elif f.dtype.kind is Kind.BOOL:
                    row[f.name] = bool(v[i])
                elif f.dtype.kind in (Kind.FLOAT32, Kind.FLOAT64):
                    row[f.name] = float(v[i])
                else:
                    row[f.name] = int(v[i])
            out.append(row)
        return out


# ---------------------------------------------------------------------------
# Device table (a jax pytree)
# ---------------------------------------------------------------------------

class DeviceTable:
    """Fixed-capacity device-resident columnar table.

    columns: name -> (values[capacity], validity[capacity]) jnp arrays
    num_rows: traced int32 scalar
    """

    __slots__ = ("schema", "columns", "num_rows")

    def __init__(self, schema: Schema,
                 columns: Dict[str, Tuple[jnp.ndarray, jnp.ndarray]],
                 num_rows):
        self.schema = schema
        self.columns = columns
        self.num_rows = num_rows

    @property
    def capacity(self) -> int:
        for v, _ in self.columns.values():
            return int(v.shape[0])
        return 0

    def column(self, name: str) -> Tuple[jnp.ndarray, jnp.ndarray]:
        return self.columns[name]

    def row_mask(self) -> jnp.ndarray:
        return jnp.arange(self.capacity, dtype=jnp.int32) < self.num_rows

    def rename(self, mapping: Dict[str, str]) -> "DeviceTable":
        fields = [f.with_name(mapping.get(f.name, f.name)) for f in self.schema.fields]
        cols = {mapping.get(n, n): c for n, c in self.columns.items()}
        return DeviceTable(Schema(fields), cols, self.num_rows)

    def select(self, names: Sequence[str]) -> "DeviceTable":
        fields = [self.schema.field(n) for n in names]
        cols = {n: self.columns[n] for n in names}
        return DeviceTable(Schema(fields), cols, self.num_rows)

    def to_host(self) -> HostTable:
        """Shrink to valid rows ON DEVICE before transferring: the
        device->host link is far slower than device memory, so padding
        must never travel."""
        n = int(self.num_rows)
        k = min(self.capacity, round_capacity(max(n, 1), minimum=8))
        leaves = []
        for f in self.schema.fields:
            v, valid = self.columns[f.name]
            leaves += [v, valid]
        small = jax.device_get(_shrink_arrays(tuple(leaves), k))
        cols = {}
        for i, f in enumerate(self.schema.fields):
            cols[f.name] = (small[2 * i][:n], small[2 * i + 1][:n])
        return HostTable(self.schema, cols, n)

    def __repr__(self):
        return (f"DeviceTable(cap={self.capacity}, cols={self.schema.names})")


from functools import partial as _partial


@_partial(jax.jit, static_argnums=1)
def _shrink_arrays(arrs, k: int):
    return tuple(a[:k] for a in arrs)


def _dt_flatten(t: DeviceTable):
    names = tuple(sorted(t.columns.keys()))
    children = tuple(t.columns[n] for n in names) + (t.num_rows,)
    return children, (t.schema, names)


def _dt_unflatten(aux, children):
    schema, names = aux
    cols = {n: children[i] for i, n in enumerate(names)}
    return DeviceTable(schema, cols, children[-1])


jax.tree_util.register_pytree_node(DeviceTable, _dt_flatten, _dt_unflatten)


# ---------------------------------------------------------------------------
# Table-level device ops used across the engine
# ---------------------------------------------------------------------------

def gather_table(t: DeviceTable, indices: jnp.ndarray, new_num_rows,
                 row_valid: Optional[jnp.ndarray] = None) -> DeviceTable:
    """New table of capacity len(indices): row j = t[indices[j]].

    `row_valid[j] = False` nulls the whole row (used for outer-join padding).
    Implemented as pack -> ONE row-gather -> unpack: one gather fetches all
    columns of a row instead of two gathers per column.
    """
    pt = pack_table(t).take_rows(indices)
    return unpack_table(pt, t.schema, new_num_rows, row_valid)


def compaction_indices(mask: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(gather_idx, n): gather_idx[j] = index of the j-th True in mask (stable).

    cumsum + scatter, O(n) — the prefix-sum compaction idiom replacing both
    Arrow's FilterBuilder in the reference probe path and a stable sort.
    Entries past n point at arbitrary kept rows; callers mask with j < n.
    """
    cap = mask.shape[0]
    n = jnp.sum(mask, dtype=jnp.int32)
    import os
    if os.environ.get("DFP_COMPACT_SCATTER"):
        # legacy cumsum+scatter idiom, kept env-gated for sandwich A/Bs
        pos = jnp.cumsum(mask, dtype=jnp.int32) - 1
        dest = jnp.where(mask, pos, cap)
        gather_idx = (jnp.zeros((cap,), jnp.int32)
                      .at[dest].set(jnp.arange(cap, dtype=jnp.int32),
                                    mode="drop"))
        return gather_idx, n
    # stable argsort of ~mask: kept rows (key 0) first in original order,
    # failing rows after — entries past n point at FAILING rows instead
    # of arbitrary kept ones, equally fine under the j < n contract.
    # argsort won the A/B against the index scatter on the first device;
    # DFP_COMPACT_SCATTER keeps the scatter for a GPU A/B (ROADMAP Queue 3).
    perm = jnp.argsort((~mask).astype(jnp.int32),
                       stable=True).astype(jnp.int32)
    return perm, n


def filter_rows(t: DeviceTable, mask: jnp.ndarray) -> DeviceTable:
    """Compact rows where mask is True to the front (stable order)."""
    (pt,), n = compact_rows([pack_table(t)], mask, t.capacity)
    return unpack_table(pt, t.schema, n)


def null_columns_like(schema: Schema, capacity: int) -> Dict[str, Tuple[jnp.ndarray, jnp.ndarray]]:
    cols = {}
    for f in schema.fields:
        cols[f.name] = (jnp.zeros((capacity,), dtype=f.dtype.device_dtype),
                        jnp.zeros((capacity,), dtype=jnp.bool_))
    return cols


# ---------------------------------------------------------------------------
# Row packing: all columns + validity of a table in ONE [W, cap] int32 matrix.
#
# The join's output materialization gathers PACKED ROWS once instead of 2
# gathers per column (values + validity). Whether the GPU prefers this
# [W, cap] layout or [cap, W] is an open question (ROADMAP Queue 1).
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PackedLayout:
    fields: Tuple[Tuple[str, Kind, int, int], ...]  # (name, kind, slot, nslots)
    f64_fields: Tuple[str, ...]  # carried unpacked beside the int32 words
    valid_base: int
    width: int


class PackedTable(NamedTuple):
    packed: jnp.ndarray                       # [W, cap] int32, W major
    f64s: Dict[str, jnp.ndarray]              # name -> float64[cap]
    layout: PackedLayout

    def take_rows(self, indices: jnp.ndarray) -> "PackedTable":
        """Gather rows: one minor-axis gather + one per float64 column.

        One gather, never chunked: on the GPU a row-gather's only temp is
        its output (an H100 A/B measured no temp at 33.5M indices x W=14
        and a faster single gather than 16 chunked ones)."""
        packed = jnp.take(self.packed, indices, axis=1, mode="clip")
        return PackedTable(
            packed,
            {n_: jnp.take(v, indices, mode="clip")
             for n_, v in self.f64s.items()},
            self.layout)


def _pt_flatten(pt: PackedTable):
    names = tuple(sorted(pt.f64s))
    return ((pt.packed,) + tuple(pt.f64s[n] for n in names),
            (pt.layout, names))


def _pt_unflatten(aux, children):
    layout, names = aux
    return PackedTable(children[0], dict(zip(names, children[1:])), layout)


# PackedTable crosses jit boundaries inside PreparedBuild (streaming hoists
# frozen build sides out of the per-chunk program); the layout is static aux
# data so jit caches per layout signature.
jax.tree_util.register_pytree_node(PackedTable, _pt_flatten, _pt_unflatten)


def take_rows_fused(pts: Sequence[PackedTable], indices: jnp.ndarray
                    ) -> List[PackedTable]:
    """Gather the same row indices from several packed tables with ONE fused
    gather: their [W_i, cap] matrices are stacked on the width axis so XLA
    issues a single gather op (gathers cost per INDEX, nearly independent of
    row width — fusing k same-index gathers is ~k-fold cheaper than k
    separate ones). f64 sidecars still gather per column (column names across
    the fused tables must be disjoint, which join sides guarantee)."""
    if len(pts) == 1:
        return [pts[0].take_rows(indices)]
    widths = [pt.packed.shape[0] for pt in pts]
    f64s: Dict[str, jnp.ndarray] = {}
    for pt in pts:
        for k, v in pt.f64s.items():
            assert k not in f64s, f"duplicate f64 column {k!r} in fused gather"
            f64s[k] = v
    merged = PackedTable(jnp.concatenate([pt.packed for pt in pts], axis=0),
                         f64s, pts[0].layout)
    g = merged.take_rows(indices)
    out, off = [], 0
    for pt, w in zip(pts, widths):
        out.append(PackedTable(g.packed[off:off + w],
                               {k: g.f64s[k] for k in pt.f64s}, pt.layout))
        off += w
    return out


def compact_rows(pts: Sequence[PackedTable], mask: jnp.ndarray,
                 out_cap: int) -> Tuple[List[PackedTable], jnp.ndarray]:
    """Compact rows where mask is True to the front of out_cap-capacity
    packed tables: a narrow index scatter builds the gather list, then ONE
    fused row-gather moves every table's rows (take_rows_fused). A direct
    wide scatter of the rows at their prefix-sum destinations lost this
    A/B on the first device (XLA lowered multi-row minor-axis scatters
    poorly); not yet measured on the GPU.

    Survivors past out_cap drop; the returned n is the TRUE survivor count
    for the caller's overflow check. Validity words of slots past the
    survivor count are zeroed, so unpacked validity bits read False without
    any row_valid mask (empty slots gather row 0's VALUES — garbage — but
    their validity reads False).
    """
    cap = mask.shape[0]
    import os
    if os.environ.get("DFP_COMPACT_SCATTER"):
        pos = jnp.cumsum(mask, dtype=jnp.int32) - 1
        keep = mask & (pos < out_cap)
        dest = jnp.where(keep, pos, out_cap)
        gidx = jnp.zeros((out_cap,), jnp.int32).at[dest].set(
            jnp.arange(cap, dtype=jnp.int32), mode="drop")
    else:
        # see compaction_indices: stable argsort replaces the index scatter;
        # the first out_cap perm entries ARE the survivor gather list
        gidx = jnp.argsort((~mask).astype(jnp.int32),
                           stable=True).astype(jnp.int32)[:out_cap]
    n = jnp.sum(mask, dtype=jnp.int32)
    ok = jnp.arange(out_cap, dtype=jnp.int32) < n
    res = []
    for pt in take_rows_fused(list(pts), gidx):
        vb = pt.layout.valid_base
        vw = jnp.where(ok[None, :], pt.packed[vb:], 0)
        res.append(PackedTable(jnp.concatenate([pt.packed[:vb], vw], axis=0),
                               pt.f64s, pt.layout))
    return res, n


def replicate_rows_exact(p: jnp.ndarray, base: jnp.ndarray,
                         count: jnp.ndarray, out_cap: int) -> jnp.ndarray:
    """Row replication: expand column i of the [W, m] int32 matrix `p` into
    output slots [base[i], base[i]+count[i)).

    ONE narrow scatter marks each non-empty segment's start slot with its
    source row id (`base` of count>0 rows is strictly increasing, so dests
    are unique), a cummax fills the ids forward through their segments, and
    ONE minor-axis row gather fetches the rows. Cost: m narrow scatter
    indices + out_cap gather indices + a 1-word cummax. The previous
    telescoping diff-scatter-add + [W, out_cap] cumsum avoided the gather
    but paid per WORD on a W-wide scatter AND cumsum; it lost the A/B on
    the first device (it was TPC-H Q9's top op).
    Gathering is trivially bit-exact for every packed word. Slots past the
    last segment hold junk; callers mask with slot < total.
    DFP_REPLICATE_SCATTER=1 selects the old diff-scatter idiom (perf A/B)."""
    import os
    if os.environ.get("DFP_REPLICATE_SCATTER"):
        d = p - jnp.pad(p[:, :-1], ((0, 0), (1, 0)))  # d[:,0] = row 0
        dest = jnp.minimum(base, out_cap)             # overflow slots drop
        scat = (jnp.zeros((p.shape[0], out_cap), p.dtype)
                .at[:, dest].add(d, mode="drop"))
        return jnp.cumsum(scat, axis=1)
    m = base.shape[0]
    dest = jnp.where(count > 0, base, out_cap)        # empty/overflow drop
    seg = (jnp.zeros((out_cap,), jnp.int32)
           .at[dest].max(jnp.arange(m, dtype=jnp.int32), mode="drop"))
    idx = jax.lax.cummax(seg)
    return jnp.take(p, idx, axis=1, mode="clip")


def packed_layout(schema: Schema) -> PackedLayout:
    fields = []
    f64s = []
    slot = 0
    for f in schema.fields:
        if f.dtype.kind is Kind.FLOAT64:
            f64s.append(f.name)
            fields.append((f.name, f.dtype.kind, -1, 0))
            continue
        n = 2 if f.dtype.kind in (Kind.INT64, Kind.DECIMAL) else 1
        fields.append((f.name, f.dtype.kind, slot, n))
        slot += n
    valid_base = slot
    width = slot + (len(schema.fields) + 31) // 32
    return PackedLayout(tuple(fields), tuple(f64s), valid_base, width)


def pack_host_slice(t: HostTable, names, lo: int, n: int, cap: int,
                    rename_prefix: str = "", rows=None):
    """Numpy mirror of pack_table over host rows [lo, lo+n), padded to `cap`:
    ONE [W, cap] int32 matrix (+ separate f64 columns) so a streamed chunk
    crosses the host->device link as a single transfer instead of one
    padded upload per column (each transfer pays a fixed overhead).

    `rows` (optional int array, len n): select THESE rows instead of the
    contiguous [lo, lo+n) range — grace-partitioned streaming packs a
    key-hash partition, whose row set is scattered across the table.

    Returns (schema, layout, packed, f64s); the device side reconstructs the
    chunk with unpack_table (elementwise bit ops, fused for free)."""
    fields = [f.with_name(rename_prefix + f.name)
              for f in t.schema.fields if f.name in names]
    schema = Schema(fields)
    layout = packed_layout(schema)
    strip = len(rename_prefix)

    def take(arr):
        if rows is not None:
            return np.asarray(arr)[rows]
        return np.asarray(arr[lo:lo + n])

    packed = np.zeros((layout.width, cap), np.int32)
    f64s = {}
    for name, kind, slot, nw in layout.fields:
        v, _ = t.columns[name[strip:]]
        v = take(v)
        if kind is Kind.FLOAT64:
            out = np.zeros(cap, np.float64)
            out[:n] = v
            f64s[name] = out
        elif nw == 2:
            vv = v.astype(np.int64, copy=False)
            packed[slot, :n] = (vv & np.int64(0xFFFFFFFF)).astype(
                np.uint32).view(np.int32)
            packed[slot + 1, :n] = (vv >> np.int64(32)).astype(np.int32)
        elif kind is Kind.FLOAT32:
            packed[slot, :n] = v.view(np.int32)
        else:
            packed[slot, :n] = v.astype(np.int32, copy=False)
    n_fields = len(layout.fields)
    for w in range((n_fields + 31) // 32):
        word = np.zeros(cap, np.uint32)
        for j in range(w * 32, min((w + 1) * 32, n_fields)):
            _, valid = t.columns[layout.fields[j][0][strip:]]
            word[:n] |= (take(valid).astype(np.uint32)
                         << np.uint32(j - w * 32))
        packed[layout.valid_base + w] = word.view(np.int32)
    return schema, layout, packed, f64s


def pack_table(t: DeviceTable) -> PackedTable:
    """All columns + validity bitmask in one [cap, W] int32 matrix (float64
    columns ride alongside)."""
    layout = packed_layout(t.schema)
    cap = t.capacity
    cols = []
    f64s = {}
    for name, kind, _, n in layout.fields:
        v, _ = t.columns[name]
        if kind is Kind.FLOAT64:
            f64s[name] = v
        elif kind in (Kind.INT64, Kind.DECIMAL):
            lo = jnp.bitwise_and(v, jnp.int64(0xFFFFFFFF)) \
                    .astype(jnp.uint32).view(jnp.int32)
            hi = (v >> jnp.int64(32)).astype(jnp.int32)
            cols += [lo, hi]
        elif kind is Kind.FLOAT32:
            cols.append(v.view(jnp.int32))
        else:  # int32/date32/string codes/bool
            cols.append(v.astype(jnp.int32))
    n_fields = len(layout.fields)
    for w in range((n_fields + 31) // 32):
        word = jnp.zeros((cap,), jnp.uint32)
        for j in range(w * 32, min((w + 1) * 32, n_fields)):
            _, valid = t.columns[layout.fields[j][0]]
            word = word | (valid.astype(jnp.uint32) << jnp.uint32(j - w * 32))
        cols.append(word.view(jnp.int32))
    return PackedTable(jnp.stack(cols, axis=0), f64s, layout)


def unpack_table(pt: PackedTable, schema: Schema, num_rows,
                 row_valid: Optional[jnp.ndarray] = None) -> DeviceTable:
    """Inverse of pack_table over (possibly gathered) packed rows."""
    packed, layout = pt.packed, pt.layout
    cols = {}
    for j, (name, kind, slot, n) in enumerate(layout.fields):
        if kind is Kind.FLOAT64:
            v = pt.f64s[name]
        elif n == 2:
            lo = packed[slot, :].view(jnp.uint32).astype(jnp.int64)
            hi = packed[slot + 1, :].astype(jnp.int64)
            v = (hi << jnp.int64(32)) | lo
        elif kind is Kind.FLOAT32:
            v = packed[slot, :].view(jnp.float32)
        elif kind is Kind.BOOL:
            v = packed[slot, :].astype(jnp.bool_)
        else:
            v = packed[slot, :]
        word = packed[layout.valid_base + j // 32, :].view(jnp.uint32)
        valid = ((word >> jnp.uint32(j % 32)) & jnp.uint32(1)).astype(jnp.bool_)
        if row_valid is not None:
            valid = valid & row_valid
        cols[name] = (v, valid)
    return DeviceTable(schema, cols, jnp.asarray(num_rows, jnp.int32))


def hstack_tables(a: DeviceTable, b: DeviceTable, num_rows) -> DeviceTable:
    """Combine columns of two same-capacity tables (e.g. join pair output)."""
    assert a.capacity == b.capacity, (a.capacity, b.capacity)
    fields = list(a.schema.fields) + list(b.schema.fields)
    cols = dict(a.columns)
    cols.update(b.columns)
    return DeviceTable(Schema(fields), cols, jnp.asarray(num_rows, jnp.int32))


def concat_tables(parts: Sequence[DeviceTable]) -> DeviceTable:
    """Stack tables with identical schemas. Each part's valid rows are packed
    at its front; result rows are compacted so all valid rows are contiguous.

    Each part is packed to its [W, cap] matrix and scattered ONCE into the
    packed result (scatters cost per index like gathers, so one packed-row
    scatter per part replaces 2 scatters per column per part); f64 sidecars
    still scatter per column."""
    assert len(parts) >= 1
    schema = parts[0].schema
    total_cap = sum(p.capacity for p in parts)
    layout = packed_layout(schema)
    out = jnp.zeros((layout.width, total_cap), jnp.int32)
    f64s = {n: jnp.zeros((total_cap,), jnp.float64) for n in layout.f64_fields}
    offset = jnp.int32(0)
    for p in parts:
        r = jnp.arange(p.capacity, dtype=jnp.int32)
        # rows past num_rows scatter out of bounds and are dropped
        idx = jnp.where(r < p.num_rows, offset + r, total_cap)
        pp = pack_table(p)
        out = out.at[:, idx].set(pp.packed, mode="drop")
        for n, v in pp.f64s.items():
            f64s[n] = f64s[n].at[idx].set(v, mode="drop")
        offset = offset + p.num_rows
    # unscattered slots keep zeroed validity words -> whole row reads as null
    return unpack_table(PackedTable(out, f64s, layout), schema, offset)
