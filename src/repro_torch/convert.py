"""State carried between the JAX package and the port, as numpy.

Both packages keep a population as packed u32 words ``[n, w]`` and a
class label per neuron, and a register file as (spike, v, LFSR,
weights).  The JAX package stores words as uint32 (checkpoints are
plain per-leaf ``.npy`` files); the port holds them as int32 bit
patterns on its device.  These functions move banks, register files and
trained models across without changing a bit, so both packages can
serve, or go on training, the same state.  Nothing here imports JAX:
the JAX side is read with ``np.asarray``.

The LM's params (and any tree of their shape: grads, AdamW's m and v),
its AdamW state and its decode caches cross too: the JAX package stacks
each position of its repeating super-block over the repeats (and keeps
the remainder layers apart); the port keeps one module, and one cache
dict, per layer, for the decoder and the encoder stacks alike.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import scan_grouping
from repro_torch.core.bitpack import as_words, words_to_numpy
from repro_torch.core.rvsnn import SnnRegFile
from repro_torch.core.trainer import SNNModel


def weights_from_jax(weights, neuron_class=None, device=None
                     ) -> tuple[torch.Tensor, np.ndarray | None]:
    """A JAX bank (numpy uint32[n, w], e.g. ``np.asarray`` of the JAX
    array or a checkpoint leaf) -> (int32[n, w] bit patterns on
    ``device``, int32[n] class map or None)."""
    w = np.asarray(weights)
    if w.ndim != 2 or w.dtype != np.uint32:
        raise ValueError(f"weights must be uint32[n, w], got {w.dtype}"
                         f"{list(w.shape)}")
    classes = None
    if neuron_class is not None:
        classes = np.asarray(neuron_class, np.int32)
        if classes.shape != (w.shape[0],):
            raise ValueError(f"neuron_class must be int[{w.shape[0]}], got "
                             f"shape {classes.shape}")
    return as_words(w, device), classes


def weights_to_numpy(weights: torch.Tensor) -> np.ndarray:
    """The port's bank -> numpy uint32[n, w], as the JAX package holds
    it."""
    return words_to_numpy(weights)


def regfile_from_jax(rf, device=None) -> SnnRegFile:
    """A JAX ``SnnRegFile`` (single or batched; any object with numpy-
    convertible ``spike``, ``v``, ``lfsr`` and ``weights``) -> the
    port's, on ``device``."""
    v = np.asarray(rf.v)
    if v.dtype != np.int32:
        raise ValueError(f"v must be int32, got {v.dtype}")
    words = {}
    for name in ("spike", "lfsr", "weights"):
        a = np.asarray(getattr(rf, name))
        if a.dtype != np.uint32:
            raise ValueError(f"{name} must be uint32, got {a.dtype}")
        words[name] = as_words(a, device)
    return SnnRegFile(spike=words["spike"],
                      v=torch.from_numpy(v.copy()).to(device),
                      lfsr=words["lfsr"], weights=words["weights"])


def regfile_to_numpy(rf: SnnRegFile) -> SnnRegFile:
    """The port's register file -> the same fields as numpy, in the JAX
    layout: uint32 spike, LFSR and weights, int32 v."""
    return SnnRegFile(spike=words_to_numpy(rf.spike),
                      v=rf.v.detach().cpu().numpy().astype(np.int32),
                      lfsr=words_to_numpy(rf.lfsr),
                      weights=words_to_numpy(rf.weights))


def model_from_jax(model, cfg=None, device=None) -> SNNModel:
    """A JAX ``SNNModel`` -> the port's, its weights and class map on
    ``device``, with the port's config ``cfg`` (the JAX config class is
    not the port's)."""
    weights, classes = weights_from_jax(np.asarray(model.weights),
                                        np.asarray(model.neuron_class),
                                        device)
    return SNNModel(weights, torch.from_numpy(classes.copy()).to(device),
                    cfg)


# --- the LM ------------------------------------------------------------------

def _layer_of_stack(stack: dict, kinds, i: int) -> dict:
    """Layer ``i`` of a JAX stack ``{"scan": [...], "rem": [...]}`` of the
    layer pattern ``kinds``: layer ``i < period * reps`` is
    ``scan[i % period]`` at repeat ``i // period``, the rest
    ``rem[i - period * reps]``."""
    period, reps, _ = scan_grouping(kinds)
    if i < period * reps:
        return _index_tree(stack["scan"][i % period], i // period)
    return stack["rem"][i - period * reps]


def _index_tree(tree, j: int):
    if isinstance(tree, dict):
        return {k: _index_tree(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]


def _put(param: torch.Tensor, leaf) -> None:
    """Copy a JAX leaf (numpy-convertible, bf16 or f32) into ``param``,
    through float32, which holds both exactly."""
    a = np.asarray(leaf).astype(np.float32)
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"shape {tuple(a.shape)} does not fit the port's "
                         f"{tuple(param.shape)}")
    param.copy_(torch.from_numpy(a))


def _blocks_tree(blocks, stack: dict, kinds, prefix: str, out: dict
                 ) -> None:
    for i, block in enumerate(blocks):
        layer = _layer_of_stack(stack, kinds, i)
        parts = [name for name, _ in block.named_children()]
        if set(parts) != set(layer):
            raise ValueError(f"{prefix} layer {i}: the JAX params hold "
                             f"{sorted(layer)}, the port {sorted(parts)}")
        for part in parts:
            mine = getattr(block, part)
            if set(mine) != set(layer[part]):
                raise ValueError(f"{prefix} layer {i} {part}: the JAX params "
                                 f"hold {sorted(layer[part])}, the port "
                                 f"{sorted(mine)}")
            for k, leaf in layer[part].items():
                out[f"{prefix}.{i}.{part}.{k}"] = leaf


def lm_tree_from_jax(model, tree) -> dict:
    """Any tree shaped as the JAX package's LM params (the params, their
    grads, AdamW's m or v; leaves numpy-convertible) -> ``{name: numpy
    array}`` keyed by the port's ``model.named_parameters()`` names: the
    ``scan`` stacks unstacked one layer at a time, the ``rem`` layers
    after them, the encoder's alike.  Every port parameter gets a leaf
    (raises where the trees differ)."""
    out = {}
    for name in ("embed", "lm_head", "pos_embed", "enc_pos"):
        if (name in tree) != hasattr(model, name):
            raise ValueError(f"{name}: in the JAX params {name in tree}, "
                             f"in the port {hasattr(model, name)}")
        if name in tree:
            out[name] = tree[name]
    for name in ("final_norm", "enc_final_norm"):
        for k, leaf in tree.get(name, {}).items():
            out[f"{name}.{k}"] = leaf
    _blocks_tree(model.layers, tree["decoder"], model.kinds, "layers", out)
    if model.cfg.is_enc_dec:
        _blocks_tree(model.encoder, tree["encoder"], model.enc_kinds,
                     "encoder", out)
    names = [n for n, _ in model.named_parameters()]
    if sorted(names) != sorted(out):
        raise ValueError(f"the JAX tree gives {sorted(set(out) - set(names))}"
                         f" beyond the port's parameters and lacks "
                         f"{sorted(set(names) - set(out))}")
    return {n: np.asarray(out[n]) for n in names}


@torch.no_grad()
def lm_params_from_jax(model, params) -> None:
    """Load the JAX package's LM params (the pytree of
    ``Model.init_params``, leaves numpy-convertible) into the port's
    ``Model`` in place, each leaf cast to the parameter's dtype: the
    embedding, head and norms, every layer's parts (stacked experts, the
    float32 router and Mamba/RWKV leaves, cross-attention), learned
    positions and the encoder stack."""
    leaves = lm_tree_from_jax(model, params)
    for name, p in model.named_parameters():
        _put(p, leaves[name])


def adamw_state_from_jax(model, state, device=None) -> dict:
    """The JAX package's AdamW state ``{"m", "v", "step"}`` for the LM's
    params -> the port's (``repro_torch.optim.AdamW``): m and v keyed by
    the port's parameter names, each leaf in its JAX dtype (bf16 or f32)
    on ``device`` (default the model's), step an int32 0-d tensor."""
    dev = model.device if device is None else device

    def tensors(tree):
        out = {}
        for name, a in lm_tree_from_jax(model, tree).items():
            dtype = (torch.bfloat16 if a.dtype.name == "bfloat16"
                     else torch.float32)
            out[name] = torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
        return out

    return {"m": tensors(state["m"]), "v": tensors(state["v"]),
            "step": torch.tensor(int(np.asarray(state["step"])),
                                 dtype=torch.int32, device=dev)}


def _tensor(leaf, model, device) -> torch.Tensor:
    """A JAX cache leaf on ``device``: float32 stays float32 (the SSM and
    RWKV states), the rest takes the model's dtype."""
    a = np.asarray(leaf)
    dtype = torch.float32 if a.dtype == np.float32 else model.dtype
    return torch.from_numpy(a.astype(np.float32)).to(device, dtype)


def lm_cache_from_jax(model, cache, device=None) -> dict:
    """The JAX package's decode cache (``{"decoder": {"scan", "rem"},
    "enc_out"?}``) -> the port's ``{"decoder": [per-layer dicts],
    "enc_out"?}`` on ``device``: every kind ("kv", "mamba", "rwkv",
    "cross") with its tensors."""
    layers = []
    for i in range(len(model.layers)):
        layer = _layer_of_stack(cache["decoder"], model.kinds, i)
        layers.append({kind: {name: _tensor(leaf, model, device)
                              for name, leaf in tensors.items()}
                       for kind, tensors in layer.items()})
    out = {"decoder": layers}
    if "enc_out" in cache:
        out["enc_out"] = _tensor(cache["enc_out"], model, device)
    return out


def lm_cache_to_numpy(cache: dict) -> dict:
    """The port's decode cache -> the same tree of float32 numpy
    arrays."""
    def leaf(t):
        return t.detach().float().cpu().numpy()

    out = {"decoder": [{kind: {name: leaf(t) for name, t in tensors.items()}
                        for kind, tensors in layer.items()}
                       for layer in cache["decoder"]]}
    if "enc_out" in cache:
        out["enc_out"] = leaf(cache["enc_out"])
    return out
