"""Named-axis sharding rules (DP/FSDP over ``pod``+``data``, TP over
``model``, sequence-split KV over ``model`` for decode).

The JAX package's rules, ported as they are: a spec is a :class:`P`, one
entry per dim (``None``, an axis name or a tuple of axis names), equal
entry by entry to the JAX ``PartitionSpec`` the reference gives.

  * **Activations** — :meth:`Rules.act_spec` maps a logical role string
    to a spec adapted to the array's rank (batch on axis 0, TP features
    on the last axis). Non-divisible dims degrade to replicated.

  * **Params** — :meth:`Rules.param_spec` walks a param tree and assigns
    Megatron-style TP (column/row rules by leaf name + parent context)
    plus FSDP over the combined ``pod``+``data`` axes on the other matrix
    dim.

  * **Inputs / caches** — token batches shard over batch axes; KV caches
    shard batch over ``data`` and **sequence over ``model``** — the layout
    under which T1's additive (num, den) combine turns cross-rank decode
    attention into one all-reduce (``core/attention.py``).

Where GSPMD places a ``NamedSharding``, the port cuts the tensor itself:
:func:`local_shard` is this rank's slice of a global tensor under a spec,
:func:`shard_tree` a whole tree's, and :func:`gather_tree` joins the
slices again. No compiler turns specs into collectives here: the TP /
FSDP layers issue their own (``distributed/collectives.py``), and
:func:`make_shard_fn`'s callable checks that an activation's local shard
has the shape its role's spec gives.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.config import MeshConfig
from repro_torch.distributed.collectives import all_gather_flat, fsdp_gather
from repro_torch.models.stack import tree_leaves, tree_map


class P(tuple):
    """A partition spec: one entry per dim, ``None`` (replicated), an
    axis name, or a tuple of axis names (the first one major). As JAX's
    ``PartitionSpec`` does, a one-name tuple is kept as the name and an
    empty one as None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else e or None)
            if isinstance(e, tuple) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __getnewargs__(self):
        # pickled as its entries (to a rank), not as one tuple entry
        return tuple(self)


# ---------------------------------------------------------------------------
# Activation roles: role -> (shard batch on axis 0, shard model on last axis)
# ---------------------------------------------------------------------------

ACT_ROLES: dict[str, tuple[bool, bool]] = {
    "act_resid": (True, False),
    "act_qkv": (True, True),
    "act_kv": (True, True),
    "act_attn_out": (True, True),
    "act_ffn": (True, True),
    "act_logits": (True, True),
    "act_moe_grouped": (True, False),
    "act_moe_slots": (True, False),
    "act_moe_hidden": (True, True),
}

# TP orientation by (parent, leaf-name). COL = output dim over model,
# ROW = input dim over model. Anything absent is replicated (plus FSDP).
_COL = {
    "wq", "wk", "wv",            # attention projections (D, out)
    "w_gate", "w_up",            # mlp up projections (D, F)
    "w_in",                      # hybrid ssm in-proj (D, inner)
    "w_r", "w_g",                # rwkv/hybrid square gates (D, D)
    "w_dt", "w_bc",              # hybrid ssm dt/B/C projections (D, small)
    "lm_head",
}
_ROW = {
    "wo",                        # attention out (q_dim, D)
    "w_down",                    # mlp down (F, D)
    "w_out",                     # ssm out (inner, D)
}
# context-sensitive leaves: (parent, name) -> "col" | "row" | "rep"
_CTX = {
    ("tm", "w_k"): "col", ("tm", "w_v"): "col", ("tm", "w_o"): "row",
    ("cm", "w_k"): "col", ("cm", "w_v"): "row", ("cm", "w_r"): "col",
    ("ssm", "w_gate"): "col",
    ("moe", "w_gate"): "moe_up", ("moe", "w_up"): "moe_up",
    ("moe", "w_down"): "moe_down",
    ("moe", "router"): "rep",
    ("tm", "decay_A"): "rep", ("tm", "decay_B"): "rep",
}
_BIAS_COL = {"bq", "bk", "bv"}   # 1-D, sized like a COL output dim


def _divides(dim: int, axes: tuple[str, ...], sizes: dict[str, int]) -> bool:
    n = 1
    for a in axes:
        n *= sizes[a]
    return dim % n == 0 and dim >= n


def _walk(tree: Any, fn, path: tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of nested dicts (the port's
    param and input trees), keeping the structure."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Sharding rule set bound to one mesh configuration."""

    mesh_cfg: MeshConfig
    seq_shard_kv: bool = True     # KV-cache sequence over `model` (T1 layout)
    # False -> params FSDP over `data` only (pod-replicated) — required by
    # the int8-EF compressed-gradient mode, whose pod hop is manual.
    fsdp_over_pod: bool = True
    # False -> activation specs never mention `pod` (the compressed-
    # gradient mode's pod-manual region). Inputs/caches keep the full
    # batch axes.
    act_over_pod: bool = True
    # False -> params are TP-sharded only (replicated over data) — the
    # serving layout for models whose TP shard fits the card.
    fsdp_params: bool = True

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return self.mesh_cfg.data_axes          # ("pod","data") or ("data",)

    @property
    def act_batch_axes(self) -> tuple[str, ...]:
        if self.act_over_pod:
            return self.batch_axes
        return tuple(a for a in self.batch_axes if a != "pod")

    @property
    def fsdp_axes(self) -> tuple[str, ...]:
        if self.fsdp_over_pod:
            return self.batch_axes
        return tuple(a for a in self.batch_axes if a != "pod")

    @property
    def model_axis(self) -> str:
        return self.mesh_cfg.model_axis

    @property
    def axis_sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh_cfg.axis_names, self.mesh_cfg.shape))

    # -- activations --------------------------------------------------------

    def act_spec(self, role: str, shape: tuple[int, ...]) -> P:
        sizes = self.axis_sizes
        batch = self.act_batch_axes
        entries: list[Any] = [None] * len(shape)

        def try_set(i: int, axes) -> None:
            ax = axes if isinstance(axes, tuple) else (axes,)
            if len(shape) > i and _divides(shape[i], ax, sizes):
                entries[i] = axes

        # decode-path roles (T1 split-KV layout): scores/exp partials are
        # sequence-sharded over `model`; q/k/v of the single new token are
        # model-replicated; a per-layer cache slice (B, S, H, Dh) keeps the
        # stored sequence over `model`.
        if role == "act_scores_decode":          # (B, H, S)
            try_set(0, batch)
            if self.seq_shard_kv:
                try_set(len(shape) - 1, self.model_axis)
            return P(*entries)
        if role == "act_decode_rep":             # (B, ...) replicated rest
            try_set(0, batch)
            return P(*entries)
        if role == "act_cache_slice":            # (B, S, H, Dh)
            try_set(0, batch)
            if self.seq_shard_kv:
                try_set(1, self.model_axis)
            return P(*entries)

        batch0, model_last = ACT_ROLES.get(role, (True, False))
        if batch0:
            try_set(0, batch)
        if model_last and len(shape) >= 2:
            try_set(len(shape) - 1, self.model_axis)
        return P(*entries)

    # -- params --------------------------------------------------------------

    def param_spec(self, path: tuple[str, ...], shape: tuple[int, ...]) -> P:
        """TP + FSDP spec for one param leaf.

        ``path`` is the tuple of dict keys from the root; leaves under a
        ``*layers`` key carry a leading stacked-L axis (never sharded).
        """
        sizes = self.axis_sizes
        name = path[-1]
        parent = path[-2] if len(path) >= 2 else ""
        stacked = any("layers" in p for p in path[:-1])
        lead = 1 if stacked else 0
        body = shape[lead:]

        kind = _CTX.get((parent, name))
        if kind is None:
            if name in _COL:
                kind = "col"
            elif name in _ROW:
                kind = "row"
            elif name == "embedding":
                kind = "embed"
            elif name in _BIAS_COL:
                kind = "bias_col"
            else:
                kind = "rep"

        entries: list[Any] = [None] * len(body)
        model = self.model_axis
        batch = self.fsdp_axes if self.fsdp_params else ()

        def set_axis(i: int, axes) -> None:
            ax = axes if isinstance(axes, tuple) else (axes,)
            if ax and _divides(body[i], ax, sizes):
                entries[i] = axes

        if kind == "col" and len(body) == 2:
            set_axis(1, model)            # output over TP
            set_axis(0, batch)            # input over FSDP
        elif kind == "row" and len(body) == 2:
            set_axis(0, model)
            set_axis(1, batch)
        elif kind == "embed" and len(body) == 2:
            set_axis(0, model)            # vocab over TP
            set_axis(1, batch)            # d_model over FSDP
        elif kind == "moe_up" and len(body) == 3:   # (E, D, F)
            set_axis(2, model)
            set_axis(1, batch)
        elif kind == "moe_down" and len(body) == 3:  # (E, F, D)
            set_axis(1, model)
            set_axis(2, batch)
        elif kind == "bias_col" and len(body) == 1:
            set_axis(0, model)
        # "rep": all None (norm scales, mus, router, decay loras, …)

        return P(*([None] * lead), *entries)

    def param_spec_tree(self, params: Any) -> Any:
        """Tree of :class:`P` matching ``params`` (tensors or anything
        with a ``shape``: meta tensors, input specs)."""
        return _walk(params,
                     lambda path, leaf: self.param_spec(path,
                                                        tuple(leaf.shape)))

    # -- inputs / caches ----------------------------------------------------

    def batch_spec(self, shape: tuple[int, ...]) -> P:
        axes = self.act_batch_axes
        entries: list[Any] = [None] * len(shape)
        if len(shape) >= 1 and _divides(shape[0], axes, self.axis_sizes):
            entries[0] = axes
        return P(*entries)

    def cache_spec(self, shape: tuple[int, ...]) -> P:
        """KV cache (L, B, S, H, Dh) / SSM state (L, B, H, N, N) / shift
        state (L, B, D): batch over ``data`` axes; for the 5-D KV cache the
        *sequence* axis shards over ``model`` (T1's split-KV layout).
        """
        sizes = self.axis_sizes
        entries: list[Any] = [None] * len(shape)
        if len(shape) >= 2 and _divides(shape[1], self.batch_axes, sizes):
            entries[1] = self.batch_axes
        if len(shape) == 5 and self.seq_shard_kv and _divides(
                shape[2], (self.model_axis,), sizes):
            entries[2] = self.model_axis
        return P(*entries)

    def input_specs_tree(self, specs: Any) -> Any:
        """Specs for an input tree (tokens/labels/cache/...): a leaf under
        a ``cache`` key takes :meth:`cache_spec`, any other
        :meth:`batch_spec`."""
        def pick(path, leaf):
            shape = tuple(leaf.shape)
            if "cache" in path:
                return self.cache_spec(shape)
            return self.batch_spec(shape)

        return _walk(specs, pick)


def make_rules(mesh_cfg: MeshConfig, *, seq_shard_kv: bool = True,
               fsdp_over_pod: bool = True,
               act_over_pod: bool = True,
               fsdp_params: bool = True) -> Rules:
    return Rules(mesh_cfg=mesh_cfg, seq_shard_kv=seq_shard_kv,
                 fsdp_over_pod=fsdp_over_pod, act_over_pod=act_over_pod,
                 fsdp_params=fsdp_params)


def local_shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's slice of the global tensor ``x`` under ``spec``, where
    a ``NamedSharding`` would place it on ``mesh``
    (:class:`repro_torch.launch.mesh.Mesh`): each named dim is cut into
    equal blocks, one per combined coordinate of its axes (the first axis
    major). A view; raises if a named dim does not divide."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than x has dims "
                         f"({x.dim()})")
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        n, idx = 1, 0
        for a in axes:
            n *= mesh.size(a)
            idx = idx * mesh.size(a) + mesh.coord(a)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"divide over {axes} ({n} ranks)")
        step = x.shape[dim] // n
        x = x.narrow(dim, idx * step, step)
    return x


def local_shape(shape: tuple[int, ...], spec: P, mesh) -> tuple[int, ...]:
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            out[dim] //= mesh.axes_size(entry)
    return tuple(out)


def no_shard(x, role: str, global_shape=None):
    return x


def make_shard_fn(mesh, rules: Optional[Rules]) -> Callable:
    """Build the ``LayerCtx.shard`` callable, ``shard(x, role,
    global_shape) -> x``: it raises ``ValueError`` unless ``x`` (this
    rank's shard of an activation whose global shape is
    ``global_shape``) has the shape ``rules.act_spec(role, global_shape)``
    gives on ``mesh``. The identity when ``mesh`` is None."""
    if mesh is None or rules is None:
        return no_shard

    def shard(x: torch.Tensor, role: str, global_shape) -> torch.Tensor:
        spec = rules.act_spec(role, tuple(global_shape))
        want = local_shape(tuple(global_shape), spec, mesh)
        if tuple(x.shape) != want:
            raise ValueError(f"{role}: the local shard of {tuple(global_shape)}"
                             f" under {spec} is {want}, not {tuple(x.shape)}")
        return x

    return shard


def fsdp_dim(spec: P, model_axis: str) -> Optional[int]:
    """The dim of a param's spec that an FSDP (batch) axis cuts, or
    None."""
    dims = [i for i, e in enumerate(spec) if e is not None
            and e != model_axis]
    return dims[0] if dims else None


def regroup(tree: Any, specs: Any, model_axis: str, pick, fn) -> Any:
    """``tree`` with ``fn(leaves, fsdp dims)`` applied to the leaves whose
    FSDP dim (:func:`fsdp_dim` of their spec in ``specs``) ``pick`` takes,
    one call a dtype (one packed collective each); ``fn`` returns the new
    leaves in order."""
    leaves = tree_leaves(tree)
    dims = tree_leaves(tree_map(lambda _, s: fsdp_dim(s, model_axis),
                                tree, specs))
    groups: dict = {}
    for i, t in enumerate(leaves):
        if pick(dims[i]):
            groups.setdefault(t.dtype, []).append(i)
    for idx in groups.values():
        for i, t in zip(idx, fn([leaves[i] for i in idx],
                                [dims[i] for i in idx])):
            leaves[i] = t
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def gather_fsdp(params: Any, specs: Any, mesh, rules: "Rules") -> Any:
    """This rank's params with every FSDP-cut dim gathered over the FSDP
    axes (one all-gather a dtype; backward: the gradients
    reduce-scattered): what the tensor-parallel layers compute on. The
    whole tree at once, as the JAX package's train step gathers it."""
    return regroup(params, specs, rules.model_axis, lambda d: d is not None,
                   lambda ts, dims: fsdp_gather(ts, dims, mesh,
                                                rules.fsdp_axes))


def shard_tree(tree: Any, spec_tree: Any, mesh) -> Any:
    """This rank's leaves of a tree of global tensors under a tree of
    specs (``named`` plus ``device_put`` in the JAX package): each a
    contiguous copy of :func:`local_shard`."""
    return _walk(tree, lambda path, leaf: local_shard(
        leaf, _at(spec_tree, path), mesh).contiguous())


def gather_tree(local_tree: Any, spec_tree: Any, mesh) -> Any:
    """The global tensors again from every rank's ``local_tree``: each
    named dim all-gathered over its axes (collective: every rank of the
    mesh calls it, in one order)."""
    def gather(path, leaf):
        for dim, entry in enumerate(_at(spec_tree, path)):
            if entry is not None and mesh.axes_size(entry) > 1:
                parts = all_gather_flat([leaf.contiguous()], mesh, entry)
                leaf = torch.cat([p[0] for p in parts], dim=dim)
        return leaf

    return _walk(local_tree, gather)


def _at(tree: Any, path: tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree
