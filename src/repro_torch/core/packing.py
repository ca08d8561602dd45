"""ULPPACK operand-packing algebra (counterpart of ``repro/core/packing.py``).

The "P1" scheme packs ``n_pack`` unsigned sub-byte operands into one wider
integer lane with field stride ``2**shift``.  One wide multiply of an
activation lane by a *field-reversed* weight lane puts the ``n_pack``-term
dot product in the middle bit-field:

  n_pack=2:  (a0 + 2^S a1) * (w1 + 2^S w0)
               = a0*w1 + 2^S * (a0*w0 + a1*w1) + 2^2S * a1*w0

Shift-mask extraction of that band from a 32-bit accumulation is exact
while at most ``k_tile`` lanes are summed (``k_tile_bound``).  Products
wrap mod 2^32 by design; only the extracted band matters.

All lattices are unsigned values stored in signed int8/int16/int32
tensors, exactly as in the reference package, so packed leaves are
byte-equal between the two.
"""

from __future__ import annotations

import dataclasses
import re

import torch

_LANE_DTYPES = {"int8": torch.int8, "int16": torch.int16,
                "int32": torch.int32}
_LANE_NAMES = {v: k for k, v in _LANE_DTYPES.items()}

# Lane dtype -> default field shift S for 2-way packing (field width = S bits).
LANE_SHIFT = {torch.int8: 4, torch.int16: 8, torch.int32: 16}

# Signed-lane headroom: a packed value must fit the signed lane dtype.
LANE_MAX = {torch.int8: 127, torch.int16: 32767, torch.int32: 2**31 - 1}

# The candidate lane-layout family (lane dtype, n_pack, shift); which
# members are feasible depends on (w_bits, a_bits) -- see layout_family.
LAYOUT_FAMILY = (
    ("int8", 2, 4),
    ("int16", 2, 8),     # default P1/P2 layout
    ("int16", 4, 4),     # binary P4 extension
    ("int32", 2, 8),
    ("int32", 2, 16),    # wide fields: huge k_tile, fewest extractions
    ("int32", 4, 8),
)


def _family_str() -> str:
    return ", ".join(f"{lane}xP{n}s{s}" for lane, n, s in LAYOUT_FAMILY)


def lane_dtype_of(name) -> torch.dtype:
    """'int16' / torch.int16 -> torch.int16 (raises on anything else)."""
    if isinstance(name, torch.dtype):
        if name in LANE_SHIFT:
            return name
    elif str(name) in _LANE_DTYPES:
        return _LANE_DTYPES[str(name)]
    raise ValueError(
        f"lane_dtype must be one of int8/int16/int32, got {name}; "
        f"supported layout family: {_family_str()}")


def lane_bytes(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static description of a packing configuration.

    Attributes:
      w_bits / a_bits: weight / activation precision (unsigned lattice width).
      lane_dtype:      integer dtype of the packed lane.
      n_pack:          operands per lane (2, or 4 for the P4 extension).
      shift:           field stride in bits (None -> lane default: LANE_SHIFT
                       for n_pack=2, lane_bits/4 for n_pack=4).

    Construction validates structure only; :attr:`feasible` says whether a
    (w_bits, a_bits) pair fits the layout overflow-free.
    """

    w_bits: int
    a_bits: int
    lane_dtype: torch.dtype = torch.int16
    n_pack: int = 2
    shift: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "lane_dtype", lane_dtype_of(self.lane_dtype))
        lane_bits = 8 * lane_bytes(self.lane_dtype)
        if self.n_pack not in (2, 4):
            raise ValueError(
                f"n_pack must be 2 or 4, got {self.n_pack}; supported layout "
                f"family: {_family_str()}")
        if self.shift is None:
            default = (LANE_SHIFT[self.lane_dtype] if self.n_pack == 2
                       else lane_bits // 4)
            object.__setattr__(self, "shift", default)
        if not isinstance(self.shift, int) or self.shift < 1:
            raise ValueError(
                f"shift must be a positive int, got {self.shift!r}; "
                f"supported layout family: {_family_str()}")
        if self.n_pack * self.shift > lane_bits:
            raise ValueError(
                f"{self.n_pack} fields of {self.shift} bits do not fit a "
                f"{lane_bits}-bit lane; supported layout family: "
                f"{_family_str()}")

    @classmethod
    def from_config(cls, qcfg) -> "PackSpec":
        """Build from a QuantConfig; raises if the configured layout cannot
        hold the configured bit widths overflow-free."""
        spec = cls(qcfg.w_bits, qcfg.a_bits, lane_dtype_of(qcfg.lane_dtype),
                   qcfg.n_pack, getattr(qcfg, "pack_shift", None))
        spec.validate()
        return spec

    def validate(self) -> "PackSpec":
        """Raise unless (w_bits, a_bits) is overflow-free under this layout."""
        if not self.feasible:
            raise ValueError(
                f"{self} is outside the overflow-free region: "
                f"k_tile_bound(w={self.w_bits}, a={self.a_bits}, "
                f"shift={self.shift}, n_pack={self.n_pack}) = {self.k_tile} "
                f"(need >= 1 and the packed value must fit the signed lane). "
                f"Feasible layouts for W{self.w_bits}A{self.a_bits}: "
                f"{[str(s) for s in layout_family(self.w_bits, self.a_bits)]}")
        return self

    @property
    def lane_name(self) -> str:
        return _LANE_NAMES[self.lane_dtype]

    @property
    def lane_bytes(self) -> int:
        return lane_bytes(self.lane_dtype)

    @property
    def field_mask(self) -> int:
        return (1 << self.shift) - 1

    @property
    def band(self) -> int:
        """Bit offset of the dot-product band: shift * (n_pack - 1)."""
        return self.shift * (self.n_pack - 1)

    @property
    def max_w(self) -> int:
        return (1 << self.w_bits) - 1

    @property
    def max_a(self) -> int:
        return (1 << self.a_bits) - 1

    @property
    def k_tile(self) -> int:
        """Packed lanes accumulable before extraction (0 => infeasible)."""
        return k_tile_bound(self.w_bits, self.a_bits, self.shift, self.n_pack)

    @property
    def feasible(self) -> bool:
        return self.k_tile >= 1 and self.packed_value_fits

    @property
    def packed_value_fits(self) -> bool:
        """Does the largest packed operand fit the signed lane dtype?"""
        stride = 1 << self.shift
        weights = sum(stride**i for i in range(self.n_pack))
        biggest = max(self.max_w, self.max_a) * weights
        return biggest <= LANE_MAX[self.lane_dtype]

    def __str__(self):
        return (f"W{self.w_bits}A{self.a_bits}/{self.lane_name}"
                f"xP{self.n_pack}s{self.shift}")

    _STR_RE = re.compile(
        r"^W(\d+)A(\d+)/(int8|int16|int32)xP(\d+)(?:s(\d+))?$")

    @classmethod
    def parse(cls, text: str) -> "PackSpec":
        """Inverse of ``str(spec)``; the shift suffix is optional and then
        resolves to the lane default."""
        m = cls._STR_RE.match(text.strip())
        if not m:
            raise ValueError(
                f"cannot parse PackSpec from {text!r} "
                f"(expected e.g. 'W2A2/int16xP2s8')")
        w, a, lane, n, s = m.groups()
        return cls(int(w), int(a), _LANE_DTYPES[lane], int(n),
                   int(s) if s is not None else None)


def k_tile_bound(w_bits: int, a_bits: int, shift: int, n_pack: int = 2) -> int:
    """Max packed lanes accumulable in 32 bits with exact extraction.

    D-field:  sum of dot terms < 2^shift
    L-carry:  sum of everything below the D band < 2^((n_pack-1)*shift)
    """
    max_w = (1 << w_bits) - 1
    max_a = (1 << a_bits) - 1
    per_lane_d = n_pack * max_w * max_a
    if per_lane_d == 0:
        return 0
    field = (1 << shift) - 1
    k_d = field // per_lane_d
    low_per_lane = sum(
        (j + 1) * max_w * max_a * (1 << (shift * j)) for j in range(n_pack - 1)
    )
    low_cap = (1 << (shift * (n_pack - 1))) - 1
    k_l = low_cap // low_per_lane if low_per_lane else k_d
    return max(0, min(k_d, k_l))


def layout_family(w_bits: int, a_bits: int,
                  base: "PackSpec | None" = None) -> tuple:
    """Feasible candidate layouts for (w_bits, a_bits), ``base`` first."""
    out = []
    if base is not None and base.feasible:
        out.append(base)
    for lane, n_pack, shift in LAYOUT_FAMILY:
        spec = PackSpec(w_bits, a_bits, _LANE_DTYPES[lane], n_pack, shift)
        if spec.feasible and spec not in out:
            out.append(spec)
    return tuple(out)


def overflow_free_region(lane_dtype=torch.int16, n_pack: int = 2,
                         max_bits: int = 8) -> dict:
    """(w_bits, a_bits) -> k_tile table (0 where the layout cannot hold
    the pair); reproduces the paper's Fig. 5 region shape."""
    table = {}
    for w in range(1, max_bits + 1):
        for a in range(1, max_bits + 1):
            spec = PackSpec(w, a, lane_dtype, n_pack)
            table[(w, a)] = spec.k_tile if spec.packed_value_fits else 0
    return table


def pad_to_multiple(x: torch.Tensor, axis: int, multiple: int
                    ) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``multiple``."""
    axis = axis % x.dim()
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _pack_fields(q: torch.Tensor, n: int, stride: int, axis: int, *,
                 reverse: bool = False) -> torch.Tensor:
    """Group ``n`` consecutive values along ``axis`` and add field j in at
    bit ``stride * j`` (``stride * (n-1-j)`` when ``reverse``), in int32
    arithmetic that wraps like XLA's s32 (for non-overlapping fields the
    sum is the bitwise OR).  One shift and one reduction whatever ``n`` is;
    the shifts are made on the tensor's device (no host copy)."""
    axis = axis % q.dim()
    q = pad_to_multiple(q.to(torch.int32), axis, n)
    shape = list(q.shape)
    shape[axis] //= n
    shape.insert(axis + 1, n)
    sh = torch.arange(n, dtype=torch.int32, device=q.device) * stride
    if reverse:
        sh = sh.flip(0)
    sh = sh.reshape([n] + [1] * (len(shape) - axis - 2))
    return (q.reshape(shape) << sh).sum(dim=axis + 1, dtype=torch.int32)


def pack_activations(q: torch.Tensor, spec: PackSpec, axis: int = -1
                     ) -> torch.Tensor:
    """Pack an unsigned activation lattice along ``axis``: q[..., 2k] in the
    LOW field, q[..., 2k+1] in the HIGH field (ascending field order)."""
    return _pack_fields(q, spec.n_pack, spec.shift, axis).to(spec.lane_dtype)


def pack_weights(q: torch.Tensor, spec: PackSpec, axis: int = 0
                 ) -> torch.Tensor:
    """Pack an unsigned weight lattice along ``axis`` in REVERSED field
    order (P1 scheme) so the dot lands in the middle band."""
    return _pack_fields(q, spec.n_pack, spec.shift, axis,
                        reverse=True).to(spec.lane_dtype)


def _unpack_fields(p: torch.Tensor, n: int, shifts, mask: int, axis: int
                   ) -> torch.Tensor:
    axis = axis % p.dim()
    p = p.to(torch.int32)
    fields = [(p >> s) & mask for s in shifts]
    stacked = torch.stack(fields, dim=axis + 1)
    shape = list(p.shape)
    shape[axis] *= n
    return stacked.reshape(shape)


def unpack(packed: torch.Tensor, spec: PackSpec, axis: int = -1,
           reversed_fields: bool = False) -> torch.Tensor:
    """Inverse of pack_activations / pack_weights (int32 lattice)."""
    pos = [(spec.n_pack - 1 - j) if reversed_fields else j
           for j in range(spec.n_pack)]
    return _unpack_fields(packed, spec.n_pack, [spec.shift * p for p in pos],
                          spec.field_mask, axis)


def pack_words(q: torch.Tensor, bits: int, axis: int = -1) -> torch.Tensor:
    """Bit-dense packing of an unsigned ``bits``-wide lattice along ``axis``:
    ``32 // bits`` values per int32 word in ascending field order, with a
    zero-padded tail (the sub-byte KV cache layout)."""
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    per = 32 // bits
    return _pack_fields(q, per, bits, axis)


def unpack_words(words: torch.Tensor, bits: int, size: int,
                 axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_words`: int32 words -> [..., size, ...] int32
    lattice values along ``axis``, dropping the zero-padded tail."""
    if not 1 <= bits <= 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    per = 32 // bits
    axis = axis % words.dim()
    out = _unpack_fields(words, per, [bits * j for j in range(per)],
                         (1 << bits) - 1, axis)
    return out.narrow(axis, 0, size)


def extract_dot(acc32: torch.Tensor, spec: PackSpec) -> torch.Tensor:
    """Shift-mask extraction of the accumulated D band from int32 totals
    (valid while at most ``spec.k_tile`` lanes were accumulated)."""
    return (acc32 >> spec.band) & spec.field_mask


def tile_dots(a3: torch.Tensor, w3: torch.Tensor,
              budget_bytes: int = 1 << 28) -> torch.Tensor:
    """Batched packed-space contraction [t, M, kt] x [t, kt, N] -> int32
    [t, M, N], wrapping mod 2^32 like XLA's s32 dot.

    On the CPU this is an int32 ``bmm`` (which wraps).  CUDA PyTorch has no
    integer matmul: there int8 / int16 operands take a float64 ``bmm``
    (:func:`tile_dots_f64`, exact), and wider ones are widened to int64,
    multiplied and summed by broadcasting (chunked over tiles to bound
    memory), the low 32 bits kept -- int64 wrap preserves the sum mod
    2^32."""
    if not a3.is_cuda:
        return torch.bmm(a3.to(torch.int32), w3.to(torch.int32))
    if a3.element_size() <= 2 and w3.element_size() <= 2 \
            and a3.shape[-1] < F64_EXACT_TERMS:
        return tile_dots_f64(a3, w3, budget_bytes)
    t, m, kt = a3.shape
    n = w3.shape[-1]
    out = torch.empty((t, m, n), dtype=torch.int32, device=a3.device)
    step = max(1, budget_bytes // max(1, m * kt * n * 8))
    for t0 in range(0, t, step):
        t1 = min(t, t0 + step)
        prod = (a3[t0:t1, :, :, None].to(torch.int64)
                * w3[t0:t1, None, :, :].to(torch.int64)).sum(dim=2)
        out[t0:t1] = wrap_i32(prod)
    return out


#: Terms of a float64 dot of 16-bit integers that stay exact: each product
#: is at most 2^30 in magnitude, so fewer than 2^23 of them sum below 2^53.
F64_EXACT_TERMS = 1 << 23


def tile_dots_f64(a3: torch.Tensor, w3: torch.Tensor,
                  budget_bytes: int = 1 << 28) -> torch.Tensor:
    """:func:`tile_dots` of int8 / int16 operands as a float64 ``bmm``
    (chunked over tiles so one chunk's products take at most
    ``budget_bytes``): every product and partial sum is an integer below
    2^53, so the float sum is the exact integer sum in any order; its low
    32 bits are kept.  The same result as the int64 broadcast, with kt
    times fewer bytes moved."""
    if a3.element_size() > 2 or w3.element_size() > 2 \
            or a3.shape[-1] >= F64_EXACT_TERMS:
        raise ValueError("tile_dots_f64 is exact for int8 / int16 operands "
                         "over fewer than 2^23 terms")
    t, m, _ = a3.shape
    n = w3.shape[-1]
    out = torch.empty((t, m, n), dtype=torch.int32, device=a3.device)
    step = max(1, budget_bytes // max(1, m * n * 8))
    for t0 in range(0, t, step):
        t1 = min(t, t0 + step)
        prod = torch.bmm(a3[t0:t1].to(torch.float64),
                         w3[t0:t1].to(torch.float64))
        out[t0:t1] = wrap_i32(prod.to(torch.int64))
    return out


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits of an int64 tensor as two's-complement int32."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def packed_matmul_reference(q_a: torch.Tensor, q_w: torch.Tensor,
                            spec: PackSpec) -> torch.Tensor:
    """Full packed matmul from lattices ("native ULPPACK" path): pack, tile
    by ``k_tile`` lanes, contract in packed space, extract and sum.
    q_a [M, K], q_w [K, N] unsigned lattices -> exact int32 [M, N]."""
    if not spec.feasible:
        raise ValueError(f"{spec} is outside the overflow-free region")
    a = pack_activations(q_a, spec, axis=-1)
    w = pack_weights(q_w, spec, axis=0)
    return packed_lanes_matmul(a, w, spec)


def packed_lanes_matmul(a: torch.Tensor, w: torch.Tensor, spec: PackSpec
                        ) -> torch.Tensor:
    """[M, Kp] x [Kp, N] packed lanes -> exact int32 [M, N]: ``k_tile``-lane
    runs contracted in packed space, each run's D band extracted, summed."""
    kt = spec.k_tile
    a = pad_to_multiple(a, -1, kt)
    w = pad_to_multiple(w, 0, kt)
    t = a.shape[-1] // kt
    a3 = a.reshape(a.shape[0], t, kt).transpose(0, 1)
    w3 = w.reshape(t, kt, w.shape[-1])
    d = extract_dot(tile_dots(a3, w3), spec)
    return d.sum(dim=0, dtype=torch.int32)
