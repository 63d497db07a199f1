"""Load the JAX package's parameters into the port's ``Model``.

``params_from_numpy`` takes the JAX params pytree with every leaf already a
numpy array (``jax.tree.map(np.asarray, params)``), unstacks the scanned
``periods`` into per-layer tensors, appends the ``tail`` layers, and
returns the port's model on ``device``.  Pure numpy to torch: nothing here
imports JAX, so both packages run identical weights with nothing
downloaded.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.models.model import Model


def _set(param: torch.Tensor, array) -> None:
    a = np.asarray(array)
    if a.shape != tuple(param.shape):
        raise ValueError(f"shape {a.shape} != {tuple(param.shape)}")
    param.copy_(torch.from_numpy(np.array(a, dtype=np.float32, order="C")))


def _layer_tree(tree, cfg: ModelConfig, i: int):
    """Layer i's params: period slot ``i % p`` at repeat ``i // p``, or a
    tail layer."""
    p_len, reps = cfg.pattern_period, cfg.num_periods
    if i < reps * p_len:
        r, slot = divmod(i, p_len)
        return _index(tree["periods"][slot], r)
    return tree["tail"][i - reps * p_len]


def _index(node, r: int):
    if isinstance(node, dict):
        return {k: _index(v, r) for k, v in node.items()}
    return np.asarray(node)[r]


def params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> Model:
    """The JAX ``init_model`` pytree (numpy leaves) as the port's model."""
    model = Model(cfg, resolve_device(device))
    with torch.no_grad():
        _set(model.embed, tree["embed"]["table"])
        _set(model.final_norm, tree["final_norm"]["scale"])
        if model.head is not None:
            _set(model.head, tree["head"]["w"])
        for i, layer in enumerate(model.layers):
            lt = _layer_tree(tree, cfg, i)
            _set(layer.norm1, lt["norm1"]["scale"])
            for name in ("wq", "wk", "wv", "wo"):
                _set(layer.attn[name], lt["attn"][name])
            if cfg.use_qk_norm:
                _set(layer.attn["q_norm"], lt["attn"]["q_norm"]["scale"])
                _set(layer.attn["k_norm"], lt["attn"]["k_norm"]["scale"])
            if layer.mlp is not None:
                _set(layer.norm2, lt["norm2"]["scale"])
                for name in layer.mlp:
                    _set(layer.mlp[name], lt["mlp"][name])
    return model
