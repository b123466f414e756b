"""Logical-axis spec trees for the LM's params and caches.

The port of the JAX package's ``repro.distributed.specs``: every
parameter and cache leaf maps to a tuple of logical axis names (resolved
against a rules table by :mod:`repro_torch.distributed.sharding`), by
the last key of its name, so the table stays in step with the model's
params without the model carrying annotations.

The port keeps one module per layer, so its spec of a layer's leaf is
the JAX package's without the leading ``"layers"`` entry of a stacked
leaf.  Params are the flat dict of ``Model.named_parameters()``
(``"layers.3.mixer.wqkv"``); caches are the model's ``{"decoder":
[per-layer dicts], "enc_out"?}``.  Spec trees have the same structure
with a tuple for every leaf.
"""

from __future__ import annotations

from repro_torch.distributed import sharding

# last name key -> logical names
_PARAM_TABLE: dict[str, tuple] = {
    "embed": ("p_vocab", "p_embed"),
    "lm_head": ("p_in", "vocab"),
    "pos_embed": (None, "p_embed"),
    "enc_pos": (None, "p_embed"),
    # attention
    "wqkv": ("p_in", "p_out"),
    "bqkv": (None,),
    "bo": (None,),
    # shared output-projection name (attn wo [H*D, d], mlp wo [ff, d],
    # rwkv wo [d, d], moe wo [E, ff, d]): all contract a model-sharded dim
    "wo": ("p_out", "p_in"),
    # mlp / moe
    "wi": ("p_in", "p_out"),
    "wg": ("p_in", "p_out"),
    "bi": (None,),
    "router": ("p_in", None),
    # mamba
    "in_proj": ("p_in", "p_out"),
    "conv_w": (None, "p_out"),
    "conv_b": ("p_out",),
    "x_proj": ("p_out", None),
    "dt_proj": (None, "p_out"),
    "dt_bias": ("p_out",),
    "A_log": ("p_out", None),
    "D": ("p_out",),
    "out_proj": ("p_out", "p_in"),
    # rwkv
    "mu": (None, None),
    "wr": ("p_in", "p_out"),
    "wk": ("p_in", "p_out"),
    "wv": ("p_in", "p_out"),
    "wd1": ("p_in", None),
    "wd2": (None, "p_out"),
    "decay_base": ("p_out",),
    "bonus": (None, None),
    "ln_scale": ("p_out",),
    # norms
    "scale": (None,),
    "bias": (None,),
}

_CACHE_TABLE: dict[str, tuple] = {
    "k": ("batch", "kv_heads", "kv_seq", "head_dim"),
    "v": ("batch", "kv_heads", "kv_seq", "head_dim"),
    "conv": ("batch", None, "ffn"),
    "ssm": ("batch", "ffn", None),
    "shift": ("batch", None),
    "state": ("batch", "heads", None, None),
    "enc_out": ("batch", None, None),
}


def param_spec(name: str, ndim: int) -> tuple:
    """The logical names of the parameter ``name`` (a
    ``named_parameters()`` name) of ``ndim`` dims.  MoE's expert tensors
    gain a leading ``"p_experts"``; an unknown or ill-fitting leaf
    replicates."""
    base = _PARAM_TABLE.get(name.rpartition(".")[2])
    if base is None:
        return (None,) * ndim
    extra = ndim - len(base)
    spec = ("p_experts",) * extra + tuple(base) if extra > 0 else tuple(base)
    return spec if len(spec) == ndim else (None,) * ndim


def param_logical_tree(params: dict) -> dict:
    """``{name: logical names}`` for a flat dict of named tensors (params,
    grads, AdamW's m or v)."""
    return {name: param_spec(name, p.ndim) for name, p in params.items()}


def cache_logical_tree(cache):
    """The logical-name tree of a decode cache (any tree of dicts and
    lists whose leaves are tensors)."""
    def walk(t, key):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, key) for v in t)
        spec = tuple(_CACHE_TABLE.get(key, (None,) * t.ndim))
        return spec if len(spec) == t.ndim else (None,) * t.ndim
    return walk(cache, None)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x)


def to_shardings(mesh, rules: dict, logical_tree, shape_tree=None):
    """Logical tree -> a tree of DTensor placements (lists, one entry per
    mesh dim).  ``shape_tree`` (tensors or shapes of the same structure,
    optional) enables per-leaf divisibility: a mesh axis that does not
    divide its dim is dropped (whisper's 1,500-frame cross cache against
    ``kv_seq``) instead of failing."""
    def build(names, leaf=None):
        shape = None
        if leaf is not None:
            shape = tuple(getattr(leaf, "shape", leaf))
        return sharding.placements(mesh, rules, names, shape)

    def walk(lt, st):
        if _is_spec(lt):
            return build(lt, st)
        if isinstance(lt, dict):
            return {k: walk(v, None if st is None else st[k])
                    for k, v in lt.items()}
        return type(lt)(walk(v, None if st is None else st[i])
                        for i, v in enumerate(lt))
    return walk(logical_tree, shape_tree)


def map_tree(fn, tree, *others):
    """``fn`` over the tensor leaves of ``tree`` (dicts, lists, tuples)
    and the same-placed leaves of ``others``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(o[k] for o in others))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return type(tree)(map_tree(fn, v, *(o[i] for o in others))
                          for i, v in enumerate(tree))
    return fn(tree, *others)


def distribute_tree(mesh, tree, placements_tree):
    """Every tensor leaf of ``tree`` as a DTensor on ``mesh`` with the
    placements at the same place of ``placements_tree`` (each rank keeps
    its shard of the full tensor it holds; no collective)."""
    from torch.distributed.tensor import distribute_tensor

    def place(t, pl):
        return distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)

    return map_tree(place, tree, placements_tree)


def place_tree(mesh, rules: dict, tree, logical_tree):
    """``tree`` as DTensors on ``mesh``, each leaf placed by its logical
    names under ``rules`` (a mesh axis that does not divide its dim
    dropped)."""
    return distribute_tree(mesh, tree, to_shardings(mesh, rules,
                                                    logical_tree, tree))


def place_params(model, mesh, rules: dict) -> dict:
    """Every parameter of ``model`` made a DTensor on ``mesh``, placed by
    ``param_logical_tree`` under ``rules``, and bound to the model.
    Returns them by name (the params a train, prefill or serve step
    takes)."""
    from repro_torch.launch.train import bind_params

    params = dict(model.named_parameters())
    return bind_params(model, place_tree(mesh, rules, params,
                                         param_logical_tree(params)))


def place_cache(cache, mesh, rules: dict):
    """A decode cache placed by ``cache_logical_tree`` under ``rules``."""
    return place_tree(mesh, rules, cache, cache_logical_tree(cache))
