"""Parameter and activation sharding (port of
videollama2_tpu/parallel/sharding.py).

One rule table maps param-tree paths to specs, as in the JAX package: a
spec names, for each dimension of a leaf, the mesh axis (or axes) it is
split over. XLA's GSPMD turns the JAX specs into collectives; here the
model places them itself, on plain local tensors:

  * each rank holds only its shard of each leaf (`shard_params`, through a
    `Layout`), a contiguous tensor, so the hand-written kernels and the
    optimizer see ordinary tensors;
  * `fsdp` is ZeRO-3: a layer's shards are all-gathered just before the
    layer runs (`gather_layer`, one layer at a time) and the gradient of
    the gather is a reduce-scatter, so gradients, Adam moments and fp32
    masters exist only as shards;
  * `tensor` is Megatron tensor parallelism: column-parallel qkv, gate/up
    (and the vision tower's qkv, fc1) on the rank's heads and columns,
    row-parallel o, down (fc2) followed by an all-reduce (`copy_to` /
    `reduce_from`, the f and g of Megatron-LM);
  * `expert` holds E / expert of Mixtral's experts a rank; the MoE FFN sums
    the local experts' outputs over the axis;
  * `seq` is Ulysses sequence parallelism (`sequence_parallel`).

Conventions (stacked-layer trees, kernels [in, out]):
  * attention qkv kernel   [L, D, (H + 2K) hd] -> (None, fsdp, tensor)
  * attention out kernel   [L, H hd, D]        -> (None, tensor, fsdp)
  * mlp gate/up            [L, D, F]           -> (None, fsdp, tensor)
  * mlp down               [L, F, D]           -> (None, tensor, fsdp)
  * MoE expert weights     [L, E, D, F]        -> (None, expert, fsdp, tensor)
  * embeddings             [V, D]              -> (None, (fsdp, tensor))
  * norms / biases / small convs / weight packs -> replicated

The port fuses q/k/v into one `qkv` entry (models/llm.py); the table is
JAX's, so `qkv` takes the rules of `q`. A contiguous column block of the
fused kernel is not a rank's heads: a rank's shard is q_r | k_r | v_r, its
query heads and the kv heads they read (`qkv_columns`), so the layer
splits it with local head counts. With fewer kv heads than `tensor` ranks
(the tiny config's 2 at tensor 4) each kv head is replicated onto the
ranks whose query heads read it, and its gradient is summed over them
(`Layout.sync_grad`). An entry holding a weight pack (int8 or int4) is
replicated whole, its bias too: JAX replicates the pack leaves, which no
`kernel$` rule matches, and a replicated pack computes its layer whole.
"""

from __future__ import annotations

import functools
import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.layers import dense
from .mesh import AXIS_NAMES, Mesh

# (path regex, spec); paths are "/"-joined tree keys, e.g.
# "llm/layers/q/kernel". First match wins. A spec entry is None, an axis
# name, or a tuple of axis names (one dimension split over several axes,
# the first outermost). Copied from the JAX package as data.
PARAM_RULES = (
    # LLM
    (r"llm/embed/weight$", (None, ("fsdp", "tensor"))),
    (r"llm/lm_head/kernel$", ("fsdp", "tensor")),
    (r"llm/layers/(q|k|v)/kernel$", (None, "fsdp", "tensor")),
    (r"llm/layers/(q|k|v)/bias$", (None, "tensor")),
    (r"llm/layers/o/kernel$", (None, "tensor", "fsdp")),
    (r"llm/layers/router/kernel$", (None, "fsdp", None)),
    (r"llm/layers/(gate|up)/kernel$", (None, "expert", "fsdp", "tensor")),
    (r"llm/layers/down/kernel$", (None, "expert", "tensor", "fsdp")),
    (r"llm/layers/.*norm/scale$", (None, None)),
    (r"llm/final_norm/scale$", (None,)),
    # Vision tower (frozen; shard the big matmuls)
    (r"vision/layers/(q|k|v|fc1)/kernel$", (None, "fsdp", "tensor")),
    (r"vision/layers/(o|fc2)/kernel$", (None, "tensor", "fsdp")),
    (r"vision/layers/fc1/bias$", (None, "tensor")),
    (r"vision/pos_embed/weight$", (None, None)),
    # Connector: 1x1 conv kernels are [1,1,Cin,Cout] matmuls
    (r"connector/s\d/b\d/conv[13]/conv/kernel$", (None, None, "fsdp",
                                                  "tensor")),
    (r"connector/sampler/kernel$", (None, None, None, "fsdp", "tensor")),
    (r"connector/readout/fc\d/kernel$", ("fsdp", "tensor")),
)

# dense-layer [L, D, F] rules when the model is dense (no expert dim)
DENSE_FFN_RULES = (
    (r"llm/layers/(gate|up)/kernel$", (None, "fsdp", "tensor")),
    (r"llm/layers/down/kernel$", (None, "tensor", "fsdp")),
)

_PACK_KEYS = ("kernel_q8", "kernel_q4")


@functools.lru_cache(maxsize=None)
def spec_for(path: str, ndim: int, is_moe: bool) -> tuple:
    """JAX `spec_for`: the first matching rule's spec, its leading axes
    dropped when it was written for a wider (MoE) layout; () replicates."""
    rules = PARAM_RULES if is_moe else (DENSE_FFN_RULES + PARAM_RULES)
    for pattern, spec in rules:
        if re.search(pattern, path):
            if len(spec) > ndim:
                spec = spec[len(spec) - ndim:]
            return spec
    return ()


def port_path(path: str) -> str:
    """The JAX path whose rule a port leaf takes: the fused `qkv` entry
    takes `q`'s."""
    return re.sub(r"(^|/)qkv/", r"\1q/", path)


def leaf_spec(path: str, ndim: int, is_moe: bool,
              entry: Optional[dict] = None) -> tuple:
    """The spec of a port leaf, padded with None to ndim. `entry` is the
    dict that holds the leaf: an entry with a weight pack is replicated."""
    if entry is not None and any(k in entry for k in _PACK_KEYS):
        return (None,) * ndim
    spec = spec_for(port_path(path), ndim, is_moe)
    return tuple(spec) + (None,) * (ndim - len(spec))


def walk(tree: dict, prefix: str = ""):
    """(path, entry, key, leaf) of every tensor leaf, depth first; entry
    is the dict that holds the leaf."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from walk(v, path)
        else:
            yield path, tree, k, v


def param_specs(params: dict, is_moe: bool = False) -> dict:
    """{path: spec} of a port param tree (JAX `param_specs`)."""
    return {path: leaf_spec(path, leaf.dim(), is_moe, entry)
            for path, entry, _, leaf in walk(params)}


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


# ---------------------------------------------------------------------------
# The current mesh (JAX's `with mesh:`), read by the model's entry points
# and passed down explicitly from there (a checkpointed layer runs again in
# the backward, on the autograd engine's thread).
# ---------------------------------------------------------------------------

_state = threading.local()


def current_mesh() -> Optional[Mesh]:
    stack = getattr(_state, "meshes", None)
    return stack[-1] if stack else None


def _push_mesh(mesh: Mesh):
    if not hasattr(_state, "meshes"):
        _state.meshes = []
    _state.meshes.append(mesh)
    return len(_state.meshes)


def _pop_mesh(token) -> None:
    del _state.meshes[token - 1:]


@contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """`with mesh:` that takes None (no mesh) too."""
    if mesh is None:
        yield None
        return
    with mesh:
        yield mesh


# ---------------------------------------------------------------------------
# Collectives with their gradients
# ---------------------------------------------------------------------------

def _gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
    dist.all_gather_into_tensor(out, x0, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    """All-gather along `dim` over `group`. The gradient is the
    reduce-scatter (sum) when the group's ranks saw different data (fsdp),
    else this rank's chunk (the ranks computed the same thing: tensor)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index, reduce_grad):
        ctx.args = (dim, group, n, index, reduce_grad)
        return _gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n, index, reduce_grad = ctx.args
        if not reduce_grad:
            chunk = g.shape[dim] // n
            return (g.narrow(dim, index * chunk, chunk).contiguous(),
                    None, None, None, None, None)
        g0 = g.movedim(dim, 0).contiguous()
        out = g0.new_empty((g0.shape[0] // n,) + tuple(g0.shape[1:]))
        dist.reduce_scatter_tensor(out, g0, group=group)
        return out.movedim(0, dim), None, None, None, None, None


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity gradient."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def _seq_to_heads(x, group, n):
    """[B, S/n, H, hd] -> [B, S, H/n, hd]: rank j gets head chunk j of
    every rank's tokens."""
    B, Sl, H, hd = x.shape
    inp = x.reshape(B, Sl, n, H // n, hd).permute(2, 0, 1, 3, 4).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return out.permute(1, 0, 2, 3, 4).reshape(B, n * Sl, H // n, hd)


def _heads_to_seq(y, group, n):
    """The inverse: [B, S, H/n, hd] -> [B, S/n, H, hd]."""
    B, S, Hn, hd = y.shape
    inp = y.reshape(B, n, S // n, Hn, hd).permute(1, 0, 2, 3, 4).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=group)
    return out.permute(1, 2, 0, 3, 4).reshape(B, S // n, n * Hn, hd)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, to_heads):
        ctx.args = (group, n, to_heads)
        return (_seq_to_heads if to_heads else _heads_to_seq)(x, group, n)

    @staticmethod
    def backward(ctx, g):
        group, n, to_heads = ctx.args
        return ((_heads_to_seq if to_heads else _seq_to_heads)(g, group, n),
                None, None, None)


def _inner_first(axes):
    """A dimension split over (a, b) holds chunk index(a) * size(b) +
    index(b): gather the inner axis first."""
    return tuple(reversed(axes))


def gather(x: torch.Tensor, dim: int, mesh: Mesh, axes: Sequence[str],
           reduce_grad: Dict[str, bool]) -> torch.Tensor:
    """All-gather dim of x over `axes` (one dimension's axes, outermost
    first); reduce_grad[axis] picks the gradient (see _AllGather)."""
    for a in _inner_first(axes):
        n = mesh.shape[a]
        if n > 1:
            x = _AllGather.apply(x, dim, mesh.group(a), n, mesh.index(a),
                                 reduce_grad[a])
    return x


# the axes whose ranks hold different samples or tokens: a gather over
# them sums its gradient, and replicated params sum theirs over them
DATA_AXES = ("data", "fsdp", "seq")
_REDUCE_GRAD = {a: a in DATA_AXES for a in AXIS_NAMES}


def copy_to(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]):
    for a in axes:
        if mesh.shape[a] > 1:
            x = _CopyTo.apply(x, mesh.group(a))
    return x


def reduce_from(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]):
    for a in axes:
        if mesh.shape[a] > 1:
            x = _ReduceFrom.apply(x, mesh.group(a))
    return x


def all_reduce_(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]):
    """In-place sum of x over `axes` (no gradient)."""
    for a in axes:
        if mesh.shape[a] > 1:
            dist.all_reduce(x, group=mesh.group(a))
    return x


def gather_tree(mesh: Optional[Mesh], tree: dict, prefix: str,
                is_moe: bool = False, keep: Sequence[str] = (),
                drop_lead: int = 0) -> dict:
    """`tree` (the subtree at `prefix`) with every leaf all-gathered over
    its spec's axes but `keep`. drop_lead: leading dims of the stacked leaf
    that the given leaves no longer have (1 for one layer of a stack)."""
    if mesh is None or all(mesh.shape[a] == 1 for a in AXIS_NAMES
                           if a not in keep):
        return tree

    def gathered(t, path):
        out = {}
        for k, v in t.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                out[k] = gathered(v, p)
                continue
            spec = leaf_spec(p, v.dim() + drop_lead, is_moe, t)[drop_lead:]
            for dim, entry in enumerate(spec):
                axes = tuple(a for a in _axes(entry))
                if any(a in keep for a in axes):
                    if not all(a in keep for a in axes):
                        raise ValueError(f"{p}: axes {axes} split between "
                                         f"gathered and kept")
                    continue
                v = gather(v, dim, mesh, axes, _REDUCE_GRAD)
            out[k] = v
        return out
    return gathered(tree, prefix)


# ---------------------------------------------------------------------------
# Heads under tensor parallelism
# ---------------------------------------------------------------------------

def local_kv_heads(H: int, K: int, t: int) -> int:
    """kv heads a tensor rank holds: K / t, or one (replicated) when t is a
    multiple of K; raises for other head counts."""
    if H % t:
        raise ValueError(f"{H} query heads do not split over tensor {t}")
    if K % t == 0:
        return K // t
    if t % K == 0:
        return 1
    raise ValueError(f"{K} kv heads do not split over (or replicate onto) "
                     f"tensor {t}")


def kv_head0(K: int, t: int, r: int) -> int:
    """The first kv head of tensor rank r."""
    return r * (K // t) if K % t == 0 else r // (t // K)


def qkv_columns(H: int, K: int, hd: int, t: int, r: int) -> torch.Tensor:
    """Column indices of tensor rank r's q_r | k_r | v_r block in the fused
    [(H + 2K) hd] layout: its H / t query heads and the kv heads they read
    (a replicated kv head when t > K)."""
    Kl = local_kv_heads(H, K, t)
    Hl, k0 = H // t, kv_head0(K, t, r)
    q = torch.arange(r * Hl * hd, (r + 1) * Hl * hd)
    k = H * hd + torch.arange(k0 * hd, (k0 + Kl) * hd)
    return torch.cat([q, k, k + K * hd])


# ---------------------------------------------------------------------------
# Layout: placing, gathering back and reducing a param tree's shards
# ---------------------------------------------------------------------------

def _is_qkv(path: str) -> bool:
    return bool(re.search(r"(^|/)layers/qkv/(kernel|bias)$", path))


class Layout:
    """How a model's param tree lies on a mesh: each leaf's spec, and the
    head counts of the fused qkv entries (cfg: a core.config.ModelConfig;
    None for a tree without qkv entries)."""

    def __init__(self, mesh: Mesh, cfg=None):
        self.mesh = mesh
        self.cfg = cfg
        self.is_moe = bool(cfg is not None and cfg.llm.is_moe)

    def heads(self, path: str) -> Tuple[int, int, int]:
        if path.startswith("vision/"):
            v = self.cfg.vision
            return v.num_heads, v.num_heads, v.head_dim
        c = self.cfg.llm
        return c.num_heads, c.num_kv_heads, c.head_dim

    def _chunk(self, axes) -> Tuple[int, int]:
        """(number of chunks, this rank's chunk) of a dim split over axes."""
        n, idx = 1, 0
        for a in axes:
            n *= self.mesh.shape[a]
            idx = idx * self.mesh.shape[a] + self.mesh.index(a)
        return n, idx

    def _qkv_tensor_dim(self, path, spec, dim) -> bool:
        return _is_qkv(path) and dim == len(spec) - 1 \
            and _axes(spec[dim]) == ("tensor",)

    def shard(self, path: str, full: torch.Tensor,
              entry: Optional[dict] = None) -> torch.Tensor:
        """This rank's shard of a leaf (a contiguous tensor on full's
        device)."""
        spec = leaf_spec(path, full.dim(), self.is_moe, entry)
        x = full
        for dim, e in enumerate(spec):
            axes = _axes(e)
            n, idx = self._chunk(axes)
            if n == 1:
                continue
            if self._qkv_tensor_dim(path, spec, dim):
                H, K, hd = self.heads(path)
                cols = qkv_columns(H, K, hd, n, idx).to(x.device)
                x = x.index_select(dim, cols)
                continue
            if x.shape[dim] % n:
                raise ValueError(f"{path}: dim {dim} of {tuple(full.shape)} "
                                 f"does not split over {axes} ({n})")
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
        return x.contiguous()

    @torch.no_grad()
    def unshard(self, path: str, local: torch.Tensor,
                entry: Optional[dict] = None) -> torch.Tensor:
        """The whole leaf from every rank's shard (collective: every rank
        of the mesh calls it; each gets the leaf)."""
        ndim = local.dim()
        spec = leaf_spec(path, ndim, self.is_moe, entry)
        x = local.contiguous()
        for dim, e in enumerate(spec):
            axes = _axes(e)
            if self._qkv_tensor_dim(path, spec, dim):
                t = self.mesh.shape["tensor"]
                if t == 1:
                    continue
                blocks = _gather_dim(x, dim, self.mesh.group("tensor"), t)
                H, K, hd = self.heads(path)
                width = x.shape[dim]
                full = x.new_empty(x.shape[:dim] + ((H + 2 * K) * hd,)
                                   + x.shape[dim + 1:])
                for r in range(t):
                    full.index_copy_(dim, qkv_columns(H, K, hd, t, r).to(
                        x.device), blocks.narrow(dim, r * width, width))
                x = full
                continue
            for a in _inner_first(axes):
                if self.mesh.shape[a] > 1:
                    x = _gather_dim(x, dim, self.mesh.group(a),
                                    self.mesh.shape[a])
        return x

    def shard_tree(self, params: dict, prefix: str = "") -> dict:
        return {k: self.shard_tree(v, f"{prefix}/{k}" if prefix else k)
                if isinstance(v, dict) else
                self.shard(f"{prefix}/{k}" if prefix else k, v, params)
                for k, v in params.items()}

    # -- gradients ----------------------------------------------------------

    def _kv_replicated(self, path: str, spec) -> bool:
        if not (_is_qkv(path) and "tensor" in _axes(spec[-1])):
            return False
        t = self.mesh.shape["tensor"]
        H, K, hd = self.heads(path)
        return t > 1 and K % t != 0

    @torch.no_grad()
    def sync_grad(self, path: str, g: torch.Tensor,
                  entry: Optional[dict] = None) -> torch.Tensor:
        """Sum a trained leaf's local gradient into its shard's gradient
        (in place): over data and seq always, over fsdp when the leaf is
        not fsdp-sharded (a sharded leaf's fsdp sum is the reduce-scatter
        of its gather), and, for a kv head replicated on several tensor
        ranks, over those ranks."""
        mesh = self.mesh
        spec = leaf_spec(path, g.dim(), self.is_moe, entry)
        used = {a for e in spec for a in _axes(e)}
        if self._kv_replicated(path, spec):
            H, K, hd = self.heads(path)
            t = mesh.shape["tensor"]
            k0 = kv_head0(K, t, mesh.index("tensor"))
            Hl = H // t
            kv = g.narrow(-1, Hl * hd, 2 * hd)
            buf = g.new_zeros(g.shape[:-1] + (2 * K * hd,))
            buf[..., k0 * hd:(k0 + 1) * hd] = kv[..., :hd]
            buf[..., (K + k0) * hd:(K + k0 + 1) * hd] = kv[..., hd:]
            dist.all_reduce(buf, group=mesh.group("tensor"))
            kv[..., :hd] = buf[..., k0 * hd:(k0 + 1) * hd]
            kv[..., hd:] = buf[..., (K + k0) * hd:(K + k0 + 1) * hd]
        all_reduce_(g, mesh, [a for a in DATA_AXES if a not in used])
        return g

    def sq_norm(self, path: str, g: torch.Tensor,
                entry: Optional[dict] = None) -> torch.Tensor:
        """This rank's share of the squared global norm of a leaf's
        gradient: the local sum of squares over the number of ranks holding
        the same values, so a sum over every rank of the mesh counts each
        value once."""
        spec = leaf_spec(path, g.dim(), self.is_moe, entry)
        used = {a for e in spec for a in _axes(e)}
        copies = self.mesh.size
        for a in used:
            copies //= self.mesh.shape[a]
        sq = g.float() ** 2
        if self._kv_replicated(path, spec):
            H, K, hd = self.heads(path)
            t = self.mesh.shape["tensor"]
            Hl = H // t
            return (torch.sum(sq[..., :Hl * hd]) / copies
                    + torch.sum(sq[..., Hl * hd:]) / (copies * (t // K)))
        s = torch.sum(sq)
        return s if copies == 1 else s / copies

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        self.all_reduce_sum(torch.zeros((), device=self.mesh.device))

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over every rank of the mesh (in place)."""
        return all_reduce_(x, self.mesh, AXIS_NAMES)


def shard_params(mesh: Mesh, params: dict, cfg=None) -> dict:
    """This rank's shards of a whole param tree, per the rule table (JAX
    `shard_params`; cfg, a ModelConfig, gives the qkv head counts and
    is_moe). The shards are contiguous tensors on the leaves' device: pass
    a host tree and move the result, so no rank holds the whole tree on its
    card."""
    return Layout(mesh, cfg).shard_tree(params)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def batch_rows(mesh: Mesh, n_rows: int, grad_accum: int = 1) -> np.ndarray:
    """The global batch rows of this rank: microbatch i is rows [i mb,
    (i + 1) mb) of the batch (JAX's reshape to [grad_accum, mb, ...]) and
    each microbatch splits over data x fsdp (JAX `constrain_batch`)."""
    n = mesh.shape["data"] * mesh.shape["fsdp"]
    r = mesh.index("data") * mesh.shape["fsdp"] + mesh.index("fsdp")
    if n_rows % grad_accum or (n_rows // grad_accum) % n:
        raise ValueError(f"a batch of {n_rows} rows does not split into "
                         f"{grad_accum} microbatches over data x fsdp {n}")
    mb = n_rows // grad_accum
    per = mb // n
    return np.concatenate([np.arange(i * mb + r * per, i * mb + (r + 1) * per)
                           for i in range(grad_accum)])


def shard_batch(batch, mesh: Mesh, grad_accum: int = 1):
    """This rank's rows of a global Batch (a NamedTuple of [B, ...]
    arrays): the port's `constrain_batch`."""
    rows = batch_rows(mesh, len(batch.valid_len), grad_accum)
    return type(batch)(*(a[rows] for a in batch))


# ---------------------------------------------------------------------------
# Ulysses sequence parallelism
#
# Tokens shard over the `seq` axis everywhere EXCEPT attention, which needs
# every key for every query: q/k/v go through an all-to-all from token
# shards to head shards (every token, H / sp heads) and the attention
# output through the inverse, the two all-to-alls of DeepSpeed-Ulysses.
# Composes with tensor parallelism: the heads split over tensor and then
# seq, so heads (and a rank's kv heads) must divide by tp * sp.
# ---------------------------------------------------------------------------

@contextmanager
def sequence_parallel(enabled: bool = True):
    """Turn sequence parallelism on for the LLM forwards called inside
    (the train step wraps its microbatches in it)."""
    prev = getattr(_state, "sp", False)
    _state.sp = enabled
    try:
        yield
    finally:
        _state.sp = prev


def sp_enabled() -> bool:
    return getattr(_state, "sp", False)


def sp_shard_seq(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B, S, ...] -> this rank's tokens [B, S / sp, ...]."""
    n = mesh.shape["seq"]
    if n == 1:
        return x
    S = x.shape[1]
    if S % n:
        raise ValueError(f"sequence of {S} tokens does not split over "
                         f"seq {n}")
    return x.narrow(1, mesh.index("seq") * (S // n), S // n)


def sp_shard_heads(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B, S / sp, H, hd] token shards -> [B, S, H / sp, hd] head shards."""
    n = mesh.shape["seq"]
    if n == 1:
        return x
    if x.shape[2] % n:
        raise ValueError(f"{x.shape[2]} heads do not split over seq {n}")
    return _AllToAll.apply(x, mesh.group("seq"), n, True)


def sp_shard_tokens(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The inverse of sp_shard_heads."""
    n = mesh.shape["seq"]
    if n == 1:
        return x
    return _AllToAll.apply(x, mesh.group("seq"), n, False)


# ---------------------------------------------------------------------------
# The decoder's plan under a mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Plan:
    """How the decoder's layers run on the current mesh: tp is the tensor
    degree of their compute (1 when the projections are weight packs,
    which stay replicated), sp the seq degree when sequence parallelism is
    on (else 1), ep the expert degree."""
    mesh: Mesh
    is_moe: bool
    tp: int
    sp: int
    ep: int

    def gather_layer(self, lp: dict, prefix: str) -> dict:
        """One layer's params with their fsdp shards gathered (ZeRO-3)."""
        return gather_tree(self.mesh, lp, prefix, self.is_moe,
                           keep=("tensor", "expert"), drop_lead=1)

    def _axes(self, moe: bool):
        """The axes a block's partial results are summed over: tensor for
        tensor-parallel compute, and expert too in the MoE FFN."""
        return (("tensor",) if self.tp > 1 else ()) + \
            (("expert",) if moe and self.ep > 1 else ())

    def parallel(self, moe: bool = False) -> bool:
        return bool(self._axes(moe))

    def enter(self, x, moe: bool = False):
        return copy_to(x, self.mesh, self._axes(moe))

    def exit(self, x, moe: bool = False):
        return reduce_from(x, self.mesh, self._axes(moe))

    def first_expert(self, num_experts: int) -> int:
        return self.mesh.index("expert") * (num_experts // self.ep)


def enter(plan: Optional[Plan], x: torch.Tensor,
          moe: bool = False) -> torch.Tensor:
    """x into a column-parallel block (Megatron's f over tensor, and over
    expert for the MoE FFN); the identity without a plan."""
    return x if plan is None else plan.enter(x, moe)


def row_dense(x: torch.Tensor, p: dict, w8a8: bool, plan: Optional[Plan],
              moe: bool = False) -> torch.Tensor:
    """ops.layers.dense of a row-parallel projection: the rank's partial
    product summed over its group (Megatron's g) before the bias."""
    if plan is None or not plan.parallel(moe):
        return dense(x, p, w8a8)
    y = plan.exit(dense(x, {k: v for k, v in p.items() if k != "bias"},
                        w8a8), moe)
    return y if p.get("bias") is None else y + p["bias"].to(y.dtype)


def _floating(layers: dict, names) -> bool:
    return all("kernel" in layers[n] for n in names if n in layers)


def plan_for(layers: dict, num_heads: int, num_kv_heads: int,
             is_moe: bool = False, names=("qkv", "o"),
             seq: bool = True) -> Optional[Plan]:
    """The Plan of a stacked layer tree on the current mesh, None without
    one. Tensor parallelism takes floating projections without LoRA
    adapters (an adapter's b is not split by heads); seq=False keeps the
    module out of sequence parallelism (the vision tower)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    tp = mesh.shape["tensor"] if _floating(layers, names) else 1
    if tp > 1 and any(isinstance(e, dict) and "lora" in e
                      for e in layers.values()):
        raise NotImplementedError("LoRA adapters under tensor parallelism "
                                  "are not supported; use data / fsdp")
    sp = mesh.shape["seq"] if seq and sp_enabled() else 1
    Kl = local_kv_heads(num_heads, num_kv_heads, tp)
    if (num_heads // tp) % sp or Kl % sp:
        raise ValueError(f"heads {num_heads} / kv heads {num_kv_heads} do "
                         f"not split over tensor {tp} x seq {sp}")
    return Plan(mesh, is_moe, tp, sp, mesh.shape["expert"])
