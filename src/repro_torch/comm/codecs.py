"""Gradient wire codecs over stacked gradient trees (cf. ``repro.comm.codecs``).

A codec maps the stacked gradient tree (every leaf ``(n, ...)``) to an
:class:`EncodedGrads` wire container (payload tensors, scale or index
sidecars, the exact wire byte count) and back.  Codecs are addressed by
the attacks' spec grammar (``core.attacks.parse_spec``):

* ``"identity"`` / ``"fp32"`` — the uncompressed reference wire;
* ``"bf16"``                  — bfloat16 truncation, 2 B a coordinate;
* ``"qsgd:bits=8"``           — QSGD stochastic quantization (Alistarh et
  al. 2017): per-row max-abs scale, unbiased stochastic rounding to
  ``2^(bits-1)-1`` integer levels;
* ``"signsgd"``               — scaled sign compression (Bernstein et al.
  2018): 1 bit a coordinate + one per-row magnitude;
* ``"topk:frac=0.01"``        — magnitude top-k with an int32 index
  sidecar.

Any codec takes ``ef=1`` for error feedback (Karimireddy et al. 2019): the
residual ``e_t = (g_t + e_{t-1}) - decode(encode(g_t + e_{t-1}))`` rides
in the trainer state, so the compression error telescopes.

Randomness: QSGD's encode is split into :func:`draw_uniform` (U[0, 1)
from a ``torch.Generator`` seeded per leaf, ``fold_seed(seed, i)``) and
the deterministic :meth:`QSGDCodec.quantize`.  torch's generator does not
give ``jax.random``'s bits, so the tests feed JAX's uniforms to
``quantize`` and expect JAX's payload exactly.

Decode invariant (the JAX package's DESIGN.md section 9): for every codec
with a dequant form, ``decode`` is exactly ``payload.float() *
mult[row]``, the form the K5 kernel (``kernels.ops.dequant_stats``)
computes its statistics from.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# the container first: core.api imports it, and this module imports api
from repro_torch.comm.container import (  # noqa: F401
    EncodedGrads, _numel, is_encoded)
from repro_torch.core import api
from repro_torch.core.attacks import leaf_generator, parse_spec
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor
Tree = Any
Shape = Tuple[int, ...]


def sidecar_leaves(enc: EncodedGrads) -> List[Optional[Tensor]]:
    """The sidecar's leaves in payload-leaf order (``None`` each when the
    codec has no sidecar)."""
    if enc.sidecar is None:
        return [None] * len(tree_leaves(enc.payload))
    return tree_leaves(enc.sidecar)


def slice_workers(enc: EncodedGrads, start: int, stop: int) -> EncodedGrads:
    """Worker rows [start, stop) of a container, as a smaller container
    whose byte count is re-derived for the sub-range."""
    if not 0 <= start < stop <= enc.n:
        raise ValueError(f"bad worker slice [{start}, {stop}) for n={enc.n}")
    codec = get_codec(enc.spec)
    m = stop - start
    shapes = tuple((m,) + tuple(s[1:]) for s in enc.shapes)
    payload = tree_map(lambda x: x[start:stop], enc.payload)
    sidecar = None if enc.sidecar is None else \
        tree_map(lambda x: x[start:stop], enc.sidecar)
    total = sum(codec.leaf_wire_bytes(s) for s in shapes)
    return EncodedGrads(payload=payload, sidecar=sidecar, spec=enc.spec,
                        n=m, shapes=shapes, wire_bytes=total)


def leaf_containers(enc: EncodedGrads) -> List[EncodedGrads]:
    """One container per leaf, in leaf order, each with its leaf's byte
    count: the units the streaming trainer's statistics add up one at a
    time."""
    codec = get_codec(enc.spec)
    return [EncodedGrads(payload=p, sidecar=s, spec=enc.spec, n=enc.n,
                         shapes=(shape,),
                         wire_bytes=codec.leaf_wire_bytes(shape))
            for p, s, shape in zip(tree_leaves(enc.payload),
                                   sidecar_leaves(enc), enc.shapes)]


def encoded_from_jax(enc: Any, *, device=None) -> EncodedGrads:
    """A JAX package's wire container carried across, as
    ``models.params_from_jax`` carries parameters (and an error-feedback
    residual, a tree of fp32 arrays): same spec, shapes and byte count;
    every payload and sidecar leaf goes through ``numpy.asarray`` and
    keeps its type (bf16 payloads stay bf16)."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":        # numpy's ml_dtypes bfloat16
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16).to(dev)
        return torch.from_numpy(a.copy()).to(dev)

    return EncodedGrads(
        payload=tree_map(conv, enc.payload),
        sidecar=None if enc.sidecar is None else tree_map(conv, enc.sidecar),
        spec=enc.spec, n=int(enc.n),
        shapes=tuple(tuple(int(d) for d in s) for s in enc.shapes),
        wire_bytes=int(enc.wire_bytes))


def _leaf2d(x: Tensor) -> Tensor:
    return x.reshape(x.shape[0], -1)


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else str(v)


def draw_uniform(shape: Shape, generator: torch.Generator) -> Tensor:
    """U[0, 1) fp32 of ``shape`` on the generator's device."""
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=generator.device)


# ==========================================================================
# the codec protocol
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class Codec:
    """Encode/decode pair over stacked gradient trees.

    Subclasses implement the leaf primitives on the ``(n, m)`` row view;
    the tree walk, error feedback, byte totals and the container are
    shared here.  ``ef=1`` turns on the error-feedback residual, which the
    trainer threads through its state (``init_residual``).
    """

    name: str = ""
    ef: float = 0.0

    @property
    def stateful(self) -> bool:
        return bool(self.ef)

    # ------------------------------------------------------- leaf primitives
    def encode_leaf(self, x: Tensor, gen: Optional[torch.Generator]
                    ) -> Tuple[Tensor, Optional[Tensor]]:
        """(n, m) fp32 -> (payload rows, sidecar rows or None)."""
        raise NotImplementedError

    def decode_leaf(self, payload: Tensor, sidecar: Optional[Tensor],
                    shape: Shape, out: Optional[Tensor] = None) -> Tensor:
        """(payload, sidecar) -> (n, m) fp32 rows, written into ``out``
        (an (n, m) fp32 tensor) when it is given."""
        raise NotImplementedError

    def leaf_wire_bytes(self, shape: Shape) -> int:
        """Exact bytes all n workers wire for one ``(n, ...)`` leaf."""
        raise NotImplementedError

    def dequant_form(self, payload: Tensor, sidecar: Optional[Tensor]
                     ) -> Optional[Tuple[Tensor, Tensor]]:
        """(payload2d, (n,) fp32 row multipliers) when the leaf's decode is
        ``payload.float() * mult[row]`` (the K5 kernel's input); ``None``
        sends the leaf through decode, then K1."""
        return None

    # ------------------------------------------------------------ tree walk
    def init_residual(self, grads_like: Tree) -> Tree:
        """Zero error-feedback state shaped like the stacked gradients."""
        return tree_map(lambda x: torch.zeros(tuple(x.shape),
                                              dtype=torch.float32,
                                              device=x.device), grads_like)

    def encode(self, grads: Tree, *, seed: Optional[int] = None,
               residual: Optional[Tree] = None, leaf_offset: int = 0
               ) -> Tuple[EncodedGrads, Optional[Tree]]:
        """Encode a stacked tree; returns (wire container, new residual).

        Leaf i draws its randomness from ``leaf_generator(device, seed,
        leaf_offset + i)``: a block of leaves that starts at leaf
        ``leaf_offset`` of the whole tree encodes as the whole-tree call
        encodes them.  With error feedback the encoder compresses
        ``g + residual`` and the new residual is the compression error,
        formed leaf by leaf so one leaf's temporaries are live at a time;
        stateless codecs return ``residual`` unchanged.  ``grads`` and
        ``residual`` are not modified.
        """
        if self.stateful and residual is None:
            raise ValueError(
                f"codec {self.name!r} with ef=1 needs a residual tree; seed "
                "it with init_residual()")
        leaves = tree_leaves(grads)
        if not leaves:
            raise ValueError("empty gradient tree")
        res_leaves = tree_leaves(residual) if self.stateful else None
        n = leaves[0].shape[0]
        payloads, sidecars, shapes, new_res = [], [], [], []
        total = 0
        for i, leaf in enumerate(leaves):
            if leaf.shape[0] != n:
                raise ValueError("all leaves must share the worker axis size")
            shape = tuple(leaf.shape)
            x = _leaf2d(leaf).float()
            if self.stateful:
                x = x + _leaf2d(res_leaves[i])
            gen = None if seed is None else \
                leaf_generator(x.device, seed, leaf_offset + i)
            p, s = self.encode_leaf(x, gen)
            if self.stateful:
                # the residual x - decode, in the decode's own buffer
                dec = self.decode_leaf(p, s, shape, torch.empty_like(x))
                new_res.append(torch.sub(x, dec, out=dec).reshape(shape))
            del x
            payloads.append(self._payload_to_leaf_shape(p, shape))
            sidecars.append(s)
            shapes.append(shape)
            total += self.leaf_wire_bytes(shape)
        sidecar = None if all(s is None for s in sidecars) else \
            tree_unflatten(grads, sidecars)
        enc = EncodedGrads(payload=tree_unflatten(grads, payloads),
                           sidecar=sidecar, spec=self.spec(), n=n,
                           shapes=tuple(shapes), wire_bytes=total)
        if not self.stateful:
            return enc, residual
        return enc, tree_unflatten(grads, new_res)

    def decode(self, enc: EncodedGrads, out: Optional[Tree] = None) -> Tree:
        """Wire container -> fp32 stacked tree (original leaf shapes).

        With ``out`` (a tree of contiguous fp32 tensors of the leaf shapes,
        such as the trainer's gradient stack) the decoded rows are written
        there and ``out`` is returned; the values are the same.
        """
        p_leaves = tree_leaves(enc.payload)
        s_leaves = sidecar_leaves(enc)
        o_leaves = [None] * len(p_leaves) if out is None else tree_leaves(out)
        dec = []
        for p, s, shape, o in zip(p_leaves, s_leaves, enc.shapes, o_leaves):
            if o is not None and (tuple(o.shape) != tuple(shape) or
                                  o.dtype != torch.float32 or
                                  not o.is_contiguous()):
                raise ValueError(f"decode out= needs contiguous float32 "
                                 f"{tuple(shape)}, got {o.dtype} "
                                 f"{tuple(o.shape)}")
            rows = self.decode_leaf(p, s, shape,
                                    None if o is None else _leaf2d(o))
            dec.append(o if o is not None else rows.reshape(shape))
        return out if out is not None else tree_unflatten(enc.payload, dec)

    def _payload_to_leaf_shape(self, payload: Tensor, shape: Shape
                               ) -> Tensor:
        """Payload rows back to the leaf shape when size-preserving (keeps
        the wire-attack and fused-stats row views trivial)."""
        if payload.numel() == int(payload.shape[0]) * _numel(shape):
            return payload.reshape(shape)
        return payload

    def spec(self) -> str:
        kv = [f"{f.name}={_fmt(getattr(self, f.name))}"
              for f in dataclasses.fields(self) if f.name != "name"
              and getattr(self, f.name) != f.default]
        return self.name + (":" + ",".join(kv) if kv else "")


def _scaled_rows(payload: Tensor, mult: Optional[Tensor],
                 out: Optional[Tensor]) -> Tensor:
    """``payload.float() * mult[:, None]`` as (n, m) rows (no multiply when
    ``mult`` is None), into ``out`` when given: the copy widens exactly and
    the multiply rounds once, as the out-of-place form does."""
    rows = _leaf2d(payload)
    if out is None:
        out = rows.float() if mult is None else rows.float() * mult[:, None]
        return out
    out.copy_(rows)
    if mult is not None:
        out.mul_(mult[:, None])
    return out


# ==========================================================================
# the codecs
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class IdentityCodec(Codec):
    """The uncompressed fp32 wire: the byte-accounting reference."""

    name: str = "identity"

    def encode_leaf(self, x, gen):
        return x, None

    def decode_leaf(self, payload, sidecar, shape, out=None):
        if out is None:
            return _leaf2d(payload)
        return out.copy_(_leaf2d(payload))

    def leaf_wire_bytes(self, shape):
        return 4 * shape[0] * _numel(shape)


@dataclasses.dataclass(frozen=True)
class BF16Codec(Codec):
    """bfloat16 truncation: 2 B a coordinate, no sidecar.  The round trip
    is the identity on values that bf16 represents."""

    name: str = "bf16"

    def encode_leaf(self, x, gen):
        return x.to(torch.bfloat16), None

    def decode_leaf(self, payload, sidecar, shape, out=None):
        return _scaled_rows(payload, None, out)

    def leaf_wire_bytes(self, shape):
        return 2 * shape[0] * _numel(shape)

    def dequant_form(self, payload, sidecar):
        p = _leaf2d(payload)
        return p, torch.ones((p.shape[0],), dtype=torch.float32,
                             device=p.device)


@dataclasses.dataclass(frozen=True)
class QSGDCodec(Codec):
    """QSGD stochastic quantization (Alistarh et al. 2017), max-abs scale.

    Per row: ``L = 2^(bits-1) - 1`` levels, scale ``s = max|g|``, payload
    ``floor(g L / s + u)`` (u ~ U[0, 1)) clipped to [-L, L] as int8,
    sidecar the dequant multiplier ``s / L``.  Stochastic rounding makes
    the decode unbiased.  Wire cost: ``bits`` per coordinate + one fp32
    scale a row a leaf.
    """

    name: str = "qsgd"
    bits: float = 8.0

    def __post_init__(self):
        b = int(self.bits)
        if not 2 <= b <= 8 or b != self.bits:
            raise ValueError(f"qsgd bits must be an integer in [2, 8], "
                             f"got {self.bits}")

    @property
    def levels(self) -> int:
        return 2 ** (int(self.bits) - 1) - 1

    def quantize(self, x: Tensor, u: Tensor) -> Tuple[Tensor, Tensor]:
        """(n, m) fp32 rows + U[0, 1) draws of the same shape -> (int8
        payload, (n,) fp32 multipliers), deterministically: the arithmetic
        of the JAX encode, in its order (the clip in fp32, then the
        cast).  The fp32 temporaries are updated in place: one (n, m)
        buffer besides ``x`` and ``u``."""
        L = float(self.levels)
        scale = torch.amax(torch.abs(x), dim=1)
        mult = scale / L
        safe = torch.where(mult > 0.0, mult, torch.ones_like(mult))
        q = x / safe[:, None]
        q.add_(u).floor_().clamp_(-L, L)
        return q.to(torch.int8), mult

    def encode_leaf(self, x, gen):
        if gen is None:
            raise ValueError("qsgd needs a PRNG seed for stochastic rounding")
        return self.quantize(x, draw_uniform(tuple(x.shape), gen))

    def decode_leaf(self, payload, sidecar, shape, out=None):
        return _scaled_rows(payload, sidecar, out)

    def leaf_wire_bytes(self, shape):
        m = _numel(shape)
        return shape[0] * ((m * int(self.bits) + 7) // 8 + 4)

    def dequant_form(self, payload, sidecar):
        return _leaf2d(payload), sidecar


@dataclasses.dataclass(frozen=True)
class SignSGDCodec(Codec):
    """Scaled sign compression (Bernstein et al. 2018): int8 +-1 payload
    (the byte count models the packed 1-bit form) + the row's mean |g|, so
    the decode keeps the row's l1 mass.  Biased: pair with ``ef=1``."""

    name: str = "signsgd"

    def encode_leaf(self, x, gen):
        mult = torch.mean(torch.abs(x), dim=1)
        sign = (x >= 0.0).to(torch.int8).mul_(2).sub_(1)
        return sign, mult

    def decode_leaf(self, payload, sidecar, shape, out=None):
        return _scaled_rows(payload, sidecar, out)

    def leaf_wire_bytes(self, shape):
        m = _numel(shape)
        return shape[0] * ((m + 7) // 8 + 4)

    def dequant_form(self, payload, sidecar):
        return _leaf2d(payload), sidecar


@dataclasses.dataclass(frozen=True)
class TopKCodec(Codec):
    """Magnitude top-k: keep the k = ceil(frac m) largest coordinates of
    each row, wire (value, int32 index) pairs.  Biased: the usual
    error-feedback client (``topk:frac=0.01,ef=1``)."""

    name: str = "topk"
    frac: float = 0.01

    def __post_init__(self):
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"topk frac must be in (0, 1], got {self.frac}")

    def row_k(self, m: int) -> int:
        return max(1, min(m, int(-(-self.frac * m // 1))))   # ceil

    def encode_leaf(self, x, gen):
        k = self.row_k(x.shape[1])
        idx = torch.topk(torch.abs(x), k, dim=1, sorted=True).indices
        return torch.gather(x, 1, idx), idx.to(torch.int32)

    def decode_leaf(self, payload, sidecar, shape, out=None):
        vals = _leaf2d(payload).float()
        if out is None:
            out = torch.zeros((vals.shape[0], _numel(shape)),
                              dtype=torch.float32, device=vals.device)
        else:
            out.zero_()
        return out.scatter_(1, _leaf2d(sidecar).long(), vals)

    def leaf_wire_bytes(self, shape):
        return shape[0] * self.row_k(_numel(shape)) * 8


CODECS: Dict[str, Any] = {
    "identity": IdentityCodec,
    "fp32": IdentityCodec,
    "bf16": BF16Codec,
    "qsgd": QSGDCodec,
    "signsgd": SignSGDCodec,
    "topk": TopKCodec,
}


def get_codec(spec: str) -> Codec:
    """Resolve a codec spec (``"name"`` or ``"name:k=v,..."``)."""
    name, kwargs = parse_spec(spec)
    try:
        cls = CODECS[name]
    except KeyError:
        raise KeyError(f"unknown codec {name!r}; available: "
                       f"{sorted(CODECS)}") from None
    fields = {f.name for f in dataclasses.fields(cls) if f.name != "name"}
    unknown = set(kwargs) - fields
    if unknown:
        raise ValueError(f"codec {name!r} has no parameter(s) "
                         f"{sorted(unknown)}; tunable: {sorted(fields)}")
    return cls(**kwargs)


def available_codecs() -> Tuple[str, ...]:
    return tuple(sorted(set(CODECS)))


# ==========================================================================
# encoded statistics
# ==========================================================================
def encoded_leaf_contrib(codec: Codec, payload: Tensor,
                         sidecar: Optional[Tensor], shape: Shape, *,
                         use_kernels: bool = False) -> Tuple[Tensor, Tensor]:
    """One encoded leaf's raw (dists, sq_norms) contribution.

    Under ``use_kernels`` a leaf with a dequant form (int8 / bf16 payload
    times a per-row multiplier) goes to K5 (``kops.dequant_stats``): the
    decoded rows never exist in device memory.  Identity and top-k leaves
    decode, then take K1 (``kops.pairwise_stats``).  Without kernels the
    leaf decodes and takes the plain formula.  Raw: unclamped, diagonal
    kept, so contributions add across leaves.
    """
    if use_kernels:
        form = codec.dequant_form(payload, sidecar)
        if form is not None:
            p, mult = form
            return kops.dequant_stats(p.contiguous(),
                                      mult.float().contiguous())
        g = codec.decode_leaf(payload, sidecar, shape)
        return kops.pairwise_stats(g.contiguous())
    g = codec.decode_leaf(payload, sidecar, shape).reshape(shape)
    return api._leaf_stats_contrib(g)


def encoded_leaf_block_contrib(codec: Codec, p_full: Tensor,
                               s_full: Optional[Tensor], shape: Shape, *,
                               row_start: int, n_loc: int,
                               n: Optional[int] = None
                               ) -> Tuple[Tensor, Tensor]:
    """Row-block partial of :func:`encoded_leaf_contrib` under kernels:
    one mesh rank's rows ``[row_start, row_start + n_loc)`` of the gathered
    container leaf ``p_full`` / ``s_full`` (of shape ``shape``) against
    all its rows.  A leaf with a dequant form goes to K7
    (``kops.dequant_stats_rect``) on its payload and multipliers, the
    rank's rows a view of them; identity and top-k leaves decode the
    gathered payload and take K6 (``kops.pairwise_stats_rect``).  The JAX
    function takes the rank's payload rows as operands of their own; here
    they are the gathered leaf's, so the kernels read them from the
    gathered stack.  ``n`` is the true worker count (the kernels take K1's
    chunk count for it), so the block equals the matching rows of K5 (K1)
    on the replicated path bit for bit."""
    rows = slice(row_start, row_start + n_loc)
    form = codec.dequant_form(p_full, s_full)
    if form is not None:
        pf, mf = form[0].contiguous(), form[1].float().contiguous()
        return kops.dequant_stats_rect(pf[rows], mf[rows], pf, mf, n=n)
    g = codec.decode_leaf(p_full, s_full, shape).contiguous()
    return kops.pairwise_stats_rect(g[rows], g, n=n)


def encoded_raw_stats(enc: EncodedGrads, *, use_kernels: bool = False
                      ) -> Tuple[Tensor, Tensor]:
    """((n, n) unfinalised sq-dists, (n,) sq-norms) summed over the
    container's leaves in leaf order: the encoded counterpart of
    ``core.api.raw_pairwise_stats`` (which delegates here)."""
    codec = get_codec(enc.spec)
    p_leaves = tree_leaves(enc.payload)
    dev = p_leaves[0].device
    total_d = torch.zeros((enc.n, enc.n), dtype=torch.float32, device=dev)
    total_s = torch.zeros((enc.n,), dtype=torch.float32, device=dev)
    for p, s, shape in zip(p_leaves, sidecar_leaves(enc), enc.shapes):
        dd, sq = encoded_leaf_contrib(codec, p, s, shape,
                                      use_kernels=use_kernels)
        total_d = total_d + dd
        total_s = total_s + sq
    return total_d, total_s


def encoded_raw_contrib(enc: EncodedGrads, *, use_kernels: bool = False
                        ) -> Tensor:
    """A container's raw (n, n) distance contribution (unclamped, diagonal
    kept): what it adds to a running total across containers."""
    return encoded_raw_stats(enc, use_kernels=use_kernels)[0]


def encoded_pairwise_stats(enc: EncodedGrads, *, use_kernels: bool = False
                           ) -> Tuple[Tensor, Tensor]:
    """Single pass over the wire container: ((n, n) finalised sq-dists,
    (n,) norms), the encoded mirror of ``core.api.tree_pairwise_stats``."""
    total_d, total_s = encoded_raw_stats(enc, use_kernels=use_kernels)
    return api.finalize_dists(total_d), total_s
