"""Shape-keyed table of the run-time choices the hand kernels leave open.

Port of ``repro/kernels/autotune.py``. The Pallas kernels take their block
sizes at dispatch time; the port's kernels fix their tiles at compile time,
so JAX's block sizes have no meaning here. What the port's wrappers do
choose per call, and what this table holds, is:

- ``flash_attention|float32|BxHxSxD`` -> ``[splits]``: how many blocks
  share each 64-row q tile's keys in the f32 forward
  (:func:`plan_key_splits`; the default rule is
  ``flash_attention.key_splits``). bf16 has no split.
- ``rmsnorm|dtype|NxD`` -> ``[variant]``: the index into
  ``rmsnorm.VARIANTS`` of K2's and K3's forward
  (:func:`plan_rmsnorm_variant`; the default rule is
  ``rmsnorm.pick_variant``). The backward kernels K2b and K3b keep
  ``pick_variant``: JAX's table has no backward entry.
- ``decode_attention|dtype|BxHxSxHD`` -> ``[page]``: the paged cache's
  page size (:func:`plan_decode_page`, as JAX's).

The key format is JAX's, string for string: every dim but the last is
bucketed to the next power of two, so a (kernel, dtype, shape) has the same
key in both packages. The table is a committed JSON file next to this one,
written by ``benchmarks_torch/bench_kernels_torch.py --tune`` on the card,
which enters a choice only where it is faster than the default rule and
gives the default's outputs bit for bit on the sweep's inputs; the port
never reads JAX's.

Every hit is validated against the call's actual shape (and, for the norm,
its bases' alignment): an entry the call cannot take is not an error, the
default rule applies and the plan says ``from_table=False``. This is
validation of a choice, never a way round a kernel failure: a wrapper that
cannot launch still raises. An empty table returns before any bucketing,
so it gives the default launches bit for bit; a non-empty one memoizes its
lookups per (kernel, dtype, shape) until it is changed.
"""
from __future__ import annotations

import importlib
import json
import os
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

# the wrappers' modules (the package exports functions of the same names),
# which import this one: their defaults are read at call time
_flash = importlib.import_module("repro_torch.kernels.flash_attention")
_rms = importlib.import_module("repro_torch.kernels.rmsnorm")

DEFAULT_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "autotune_table.json")
TABLE_VERSION = 1

DECODE_DEFAULT_PAGE = 128
DECODE_PAGE_CANDIDATES: Tuple[int, ...] = (64, 128, 256)
# the f32 forward's key splits the --tune sweep tries (those a shape takes)
KEY_SPLIT_CANDIDATES: Tuple[int, ...] = (1, 2, 4, 8)
KEY_TILE = 64              # keys a block of the f32 forward takes at a time
MAX_KEY_SPLITS = 64        # the C entry's limit (csrc/flash_attention.cu)


def _pow2_bucket(n: int) -> int:
    """Smallest power of two >= n (bucket label for a shape dimension)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def shape_bucket(shape: Sequence[int]) -> Tuple[int, ...]:
    """Bucket every dim to the next pow2 except the exact trailing dim."""
    dims = tuple(int(d) for d in shape)
    return tuple(_pow2_bucket(d) for d in dims[:-1]) + (dims[-1],)


def dtype_name(dtype) -> str:
    """``bfloat16`` or ``float32`` for a torch dtype (or its name)."""
    return str(dtype).removeprefix("torch.")


def table_key(kernel: str, dtype, shape: Sequence[int]) -> str:
    """Canonical string key: ``kernel|dtype|b1x2x512x128``-style buckets."""
    dims = "x".join(str(d) for d in shape_bucket(shape))
    return f"{kernel}|{dtype_name(dtype)}|{dims}"


class AutotuneTable:
    """The persisted (kernel, dtype, shape bucket) -> choice mapping."""

    def __init__(self, entries: Optional[Dict[str, List[int]]] = None):
        self.entries: Dict[str, List[int]] = dict(entries or {})
        self._memo: Dict[tuple, Optional[Tuple[int, ...]]] = {}

    @classmethod
    def load(cls, path: str = DEFAULT_TABLE_PATH) -> "AutotuneTable":
        """Load a table; a missing or unreadable file is an empty table."""
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            return cls()
        return cls(data.get("entries", {}))

    def save(self, path: str = DEFAULT_TABLE_PATH) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"version": TABLE_VERSION,
                       "entries": dict(sorted(self.entries.items()))},
                      f, indent=1, sort_keys=True)
            f.write("\n")

    def lookup(self, kernel: str, dtype,
               shape: Sequence[int]) -> Optional[Tuple[int, ...]]:
        hit = self.entries.get(table_key(kernel, dtype, shape))
        return tuple(int(b) for b in hit) if hit else None

    def record(self, kernel: str, dtype, shape: Sequence[int],
               choice: Sequence[int]) -> None:
        self.entries[table_key(kernel, dtype, shape)] = [int(b)
                                                         for b in choice]
        self._memo.clear()

    def cached(self, kernel: str, dtype,
               shape: Tuple[int, ...]) -> Optional[Tuple[int, ...]]:
        """:meth:`lookup`, memoized per (kernel, dtype, shape)."""
        key = (kernel, dtype, shape)
        try:
            return self._memo[key]
        except KeyError:
            hit = self._memo[key] = self.lookup(kernel, dtype, shape)
            return hit


_TABLE: Optional[AutotuneTable] = None


def get_table() -> AutotuneTable:
    """Process-wide table loaded once from the committed file."""
    global _TABLE
    if _TABLE is None:
        _TABLE = AutotuneTable.load()
    return _TABLE


@contextmanager
def override(table: AutotuneTable) -> Iterator[AutotuneTable]:
    """Swap the process-wide table (tests and the bench pin entries)."""
    global _TABLE
    prev = _TABLE
    _TABLE = table
    try:
        yield table
    finally:
        _TABLE = prev


# ---------------------------------------------------------------------------
# Candidates and plans
# ---------------------------------------------------------------------------

def key_split_limit(S: int) -> int:
    """Most blocks a q tile's keys may be split over at sequence length S:
    one 64-key tile a run at least, and the C entry's limit."""
    return min(-(-int(S) // KEY_TILE), MAX_KEY_SPLITS)


def key_split_candidates(S: int) -> List[int]:
    """The sweep's splits that a sequence of S keys takes."""
    return [n for n in KEY_SPLIT_CANDIDATES if n <= key_split_limit(S)]


def plan_key_splits(B: int, S: int, H: int, D: int, dtype: torch.dtype,
                    sms: int, table: Optional[AutotuneTable] = None
                    ) -> Tuple[int, bool]:
    """(splits, from_table) for the f32 forward on q (B, S, H, D) on a card
    with ``sms`` SMs. A hit applies where 1 <= splits <=
    :func:`key_split_limit`; else ``key_splits``'s rule. bf16 always 1."""
    default = _flash.key_splits(B, S, H, dtype, sms)
    if dtype != torch.float32:
        return default, False
    table = get_table() if table is None else table
    if not table.entries:
        return default, False
    hit = table.cached("flash_attention", dtype, (B, H, S, D))
    if hit is not None and len(hit) == 1 \
            and 1 <= hit[0] <= key_split_limit(S):
        return hit[0], True
    return default, False


def rmsnorm_variant_legal(variant: int, D: int, vector: bool) -> bool:
    """Whether a norm kernel variant takes rows of D: ``warp`` up to
    WARP_MAX_WIDTH and ``wide`` up to MAX_WIDTH, both only with 16-byte
    rows and aligned bases (``vector``); ``scalar`` any row."""
    if not 0 < D <= _rms.MAX_WIDTH:
        return False
    if variant == 0:
        return vector and D <= _rms.WARP_MAX_WIDTH
    return variant == 2 or (variant == 1 and vector)


def rmsnorm_variant_candidates(D: int, vector: bool = True) -> List[int]:
    return [v for v in range(len(_rms.VARIANTS))
            if rmsnorm_variant_legal(v, D, vector)]


def plan_rmsnorm_variant(x: torch.Tensor, *others: torch.Tensor,
                         table: Optional[AutotuneTable] = None
                         ) -> Tuple[int, bool]:
    """(variant, from_table) for K2's or K3's forward on the rows of ``x``
    read beside ``others``: a hit that :func:`rmsnorm_variant_legal` allows
    for this call, else ``pick_variant``'s choice."""
    D = x.shape[-1]
    return plan_rmsnorm_rows(x.numel() // D if D else 0, D, x.dtype,
                             _rms.vector_access(x, *others), table)


def plan_rmsnorm_rows(N: int, D: int, dtype: torch.dtype, vector: bool,
                      table: Optional[AutotuneTable] = None
                      ) -> Tuple[int, bool]:
    """:func:`plan_rmsnorm_variant` for N rows of D, given whether the
    16-byte variants take the call (``rmsnorm.vector_access``)."""
    default = _rms.variant_for(D, vector)
    table = get_table() if table is None else table
    if not table.entries:
        return default, False
    hit = table.cached("rmsnorm", dtype, (N, D))
    if hit is not None and len(hit) == 1 \
            and rmsnorm_variant_legal(hit[0], D, vector):
        return hit[0], True
    return default, False


def decode_page_candidates(S: int) -> List[int]:
    """Page sizes dividing the cache length (block tables need whole pages)."""
    return [p for p in DECODE_PAGE_CANDIDATES if S % p == 0] or [S]


def plan_decode_page(shape: Sequence[int], dtype,
                     table: Optional[AutotuneTable] = None
                     ) -> Tuple[int, bool]:
    """(page_size, from_table) for a (B, H, S, HD)-shaped paged decode.
    Pages must tile the cache length exactly; a non-dividing entry falls
    back to the default."""
    S = int(shape[2])
    table = get_table() if table is None else table
    hit = table.lookup("decode_attention", dtype, shape)
    if hit is not None and len(hit) == 1 and S % hit[0] == 0:
        return hit[0], True
    return (DECODE_DEFAULT_PAGE if S % DECODE_DEFAULT_PAGE == 0 else S,
            False)
