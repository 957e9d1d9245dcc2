"""MiniLM parameter artifacts and their conversion to the port's modules.

``save_params_npz`` / ``load_params_npz`` and ``convert_hf_bert`` (an
HF ``BertModel`` state dict into the param pytree) are the JAX
package's code verbatim: the param pytree (nested dicts and lists of
arrays) is flattened into an npz archive keyed by '/'-joined paths.
:func:`minilm_state_dict_from_jax` turns that pytree into the state
dict of :class:`legal_rag_tpu_torch.models.minilm.MiniLM`, and
:func:`minilm_params_from_state_dict` turns a (trained) module's state
back into the pytree, bit for bit, which ``VectorStore.save`` writes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from legal_rag_tpu_torch.config import EncoderConfig

MiniLMParams = Dict[str, Any]

_ATTENTION = ("query", "key", "value", "output")


def _dense(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    # torch Linear stores weight [out, in]; our kernels are [in, out]
    return {
        "kernel": np.ascontiguousarray(np.asarray(sd[prefix + ".weight"]).T),
        "bias": np.asarray(sd[prefix + ".bias"]),
    }


def _ln(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "scale": np.asarray(sd[prefix + ".weight"]),
        "bias": np.asarray(sd[prefix + ".bias"]),
    }


def convert_hf_bert(
    state_dict: Mapping[str, Any], cfg: EncoderConfig
) -> MiniLMParams:
    """Convert an HF ``BertModel`` state_dict (tensors or ndarrays,
    key layout ``embeddings.* / encoder.layer.N.*``) into the pytree
    :func:`legal_rag_tpu.models.minilm.minilm_hidden_states` consumes."""
    sd = {
        k.removeprefix("bert."): np.asarray(
            v.detach().cpu().numpy() if hasattr(v, "detach") else v
        )
        for k, v in state_dict.items()
    }
    layers = []
    for n in range(cfg.layers):
        p = f"encoder.layer.{n}"
        layers.append({
            "attention": {
                "query": _dense(sd, f"{p}.attention.self.query"),
                "key": _dense(sd, f"{p}.attention.self.key"),
                "value": _dense(sd, f"{p}.attention.self.value"),
                "output": _dense(sd, f"{p}.attention.output.dense"),
            },
            "attention_ln": _ln(sd, f"{p}.attention.output.LayerNorm"),
            "intermediate": _dense(sd, f"{p}.intermediate.dense"),
            "output": _dense(sd, f"{p}.output.dense"),
            "output_ln": _ln(sd, f"{p}.output.LayerNorm"),
        })
    return {
        "embeddings": {
            "word": sd["embeddings.word_embeddings.weight"],
            "position": sd["embeddings.position_embeddings.weight"],
            "token_type": sd["embeddings.token_type_embeddings.weight"],
            "ln": _ln(sd, "embeddings.LayerNorm"),
        },
        "layers": layers,
    }


def save_params_npz(params: MiniLMParams, path) -> None:
    """Flatten the pytree into an npz archive (key = '/'-joined path)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}")
        else:
            flat[prefix] = np.asarray(node)

    walk(params, "")
    np.savez_compressed(path, **flat)


def load_params_npz(path) -> MiniLMParams:
    data = np.load(path)
    root: Dict[str, Any] = {}
    for key in data.files:
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = data[key]

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def minilm_state_dict_from_jax(params: MiniLMParams) -> Dict[str, torch.Tensor]:
    """The JAX MiniLM param pytree -> the port's ``MiniLM`` state dict.

    Linear ``kernel [in, out]`` becomes ``weight [out, in]``; LayerNorm
    ``scale`` becomes ``weight``. Table sizes come from the arrays
    themselves (random-init stores size the word table to the WordPiece
    vocab, not to ``EncoderConfig.vocab_size``).
    """
    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}

    def linear(prefix: str, p) -> None:
        sd[prefix + ".weight"] = t(np.asarray(p["kernel"]).T)
        sd[prefix + ".bias"] = t(p["bias"])

    def ln(prefix: str, p) -> None:
        sd[prefix + ".weight"] = t(p["scale"])
        sd[prefix + ".bias"] = t(p["bias"])

    emb = params["embeddings"]
    sd["word.weight"] = t(emb["word"])
    sd["position.weight"] = t(emb["position"])
    sd["token_type.weight"] = t(emb["token_type"])
    ln("emb_ln", emb["ln"])
    for n, lp in enumerate(params["layers"]):
        p = f"layers.{n}"
        for name in _ATTENTION:
            linear(f"{p}.attention.{name}", lp["attention"][name])
        ln(f"{p}.attention_ln", lp["attention_ln"])
        linear(f"{p}.intermediate", lp["intermediate"])
        linear(f"{p}.output", lp["output"])
        ln(f"{p}.output_ln", lp["output_ln"])
    return sd


def minilm_params_from_state_dict(
    sd: Mapping[str, torch.Tensor],
) -> MiniLMParams:
    """The inverse of :func:`minilm_state_dict_from_jax`: a ``MiniLM``
    state dict (e.g. of a trained module) -> the JAX param pytree as
    float32 numpy arrays, bit for bit."""
    def a(key: str) -> np.ndarray:
        return sd[key].detach().cpu().numpy().astype(np.float32)

    def linear(prefix: str) -> Dict[str, np.ndarray]:
        return {"kernel": np.ascontiguousarray(a(prefix + ".weight").T),
                "bias": a(prefix + ".bias")}

    def ln(prefix: str) -> Dict[str, np.ndarray]:
        return {"scale": a(prefix + ".weight"), "bias": a(prefix + ".bias")}

    n_layers = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
    layers = []
    for n in range(n_layers):
        p = f"layers.{n}"
        layers.append({
            "attention": {name: linear(f"{p}.attention.{name}")
                          for name in _ATTENTION},
            "attention_ln": ln(f"{p}.attention_ln"),
            "intermediate": linear(f"{p}.intermediate"),
            "output": linear(f"{p}.output"),
            "output_ln": ln(f"{p}.output_ln"),
        })
    return {
        "embeddings": {
            "word": a("word.weight"),
            "position": a("position.weight"),
            "token_type": a("token_type.weight"),
            "ln": ln("emb_ln"),
        },
        "layers": layers,
    }
