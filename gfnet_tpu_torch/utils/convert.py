"""Weight bridge from the JAX package's parameter trees to this port.

  - `flax_to_torch_vit`: the ViT's flax params → `VisionTransformer.state_dict()`
    (the torch DINOv2 layout);
  - `flax_to_torch_head`: the head's {"params", "batch_stats"} → `GFNet.state_dict()`
    (the reference GFNet checkpoint layout), composed of the per-module
    bridges `flax_to_torch_crossview`, `_encoder`, `_fpn_decoder` and `_refiner`;
  - `load_head_npz`: an `.npz` head with flat `params/...`, `batch_stats/...`
    keys → (state_dict, kv_norm); `load_vit_npz`: converted DINOv2 weights.

Trees are nested dicts of numpy arrays (or anything `np.asarray` takes).
Layouts: flax Dense kernels are (in, out), torch's (out, in); conv kernels
HWIO → OIHW (the depthwise (K, K, 1, C) → (C, 1, K, K)); `nn.scan` stacks a
leading depth axis on `blocks/block/*` and `refiners_*/hidden/block/*`;
LayerNorm `scale` is `weight`; BatchNorm `mean`/`var` are `running_mean`/
`running_var`. Nothing here touches `os.environ`.
"""

from __future__ import annotations

import numpy as np
import torch

SCALES = ("16", "8", "4", "2", "1")
ENCODER_BLOCKS = ("conv00", "conv01", "downsample1", "conv10", "conv11", "downsample2",
                  "conv20", "conv21", "downsample3", "conv30", "conv31")
DECODER_BLOCKS = ("out0", "inner1", "out1", "inner2", "out2", "inner3", "out3")


def _lin(w) -> np.ndarray:
    return np.asarray(w).T


def _conv(w) -> np.ndarray:
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _get(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _tensors(sd: dict, prefix: str = "") -> dict:
    return {prefix + k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def flax_to_torch_vit(vit_params: dict) -> dict:
    """JAX `VisionTransformer` params (with or without the outer "params") →
    state dict of the port's `VisionTransformer`."""
    p = vit_params.get("params", vit_params)
    sd = {
        "patch_embed.proj.weight": _conv(_get(p, "patch_embed/kernel")),
        "patch_embed.proj.bias": _get(p, "patch_embed/bias"),
        "cls_token": _get(p, "cls_token"),
        "pos_embed": _get(p, "pos_embed"),
        "norm.weight": _get(p, "norm/scale"),
        "norm.bias": _get(p, "norm/bias"),
    }
    blk = _get(p, "blocks/block")
    pairs = [("norm1.weight", "norm1/scale", None), ("norm1.bias", "norm1/bias", None),
             ("attn.qkv.weight", "attn/qkv/kernel", _lin), ("attn.qkv.bias", "attn/qkv/bias", None),
             ("attn.proj.weight", "attn/proj/kernel", _lin), ("attn.proj.bias", "attn/proj/bias", None),
             ("ls1.gamma", "ls1/gamma", None), ("ls2.gamma", "ls2/gamma", None),
             ("norm2.weight", "norm2/scale", None), ("norm2.bias", "norm2/bias", None)]
    for name in blk["mlp"]:  # fc1/fc2, or w12/w3 for the SwiGLU FFN
        pairs += [(f"mlp.{name}.weight", f"mlp/{name}/kernel", _lin),
                  (f"mlp.{name}.bias", f"mlp/{name}/bias", None)]
    for torch_name, flax_path, tf in pairs:
        for i, leaf in enumerate(np.asarray(_get(blk, flax_path))):
            sd[f"blocks.{i}.{torch_name}"] = tf(leaf) if tf else leaf
    return _tensors(sd)


def flax_to_torch_crossview(p: dict) -> dict:
    """JAX `CrossViewDecoder` params → the port's `CrossViewDecoder` state dict."""
    sd = {"proj.weight": _lin(_get(p, "proj/kernel"))}
    for i in range(sum(k.startswith("cross") for k in p)):
        c, t = p[f"cross{i}"], f"cross_attn_blocks.{i}."
        sd[t + "norm1.weight"] = _get(c, "norm1/scale")
        sd[t + "norm1.bias"] = _get(c, "norm1/bias")
        for proj in ("q_proj", "k_proj", "v_proj", "proj"):
            sd[t + f"attn.{proj}.weight"] = _lin(_get(c, f"attn/{proj}/kernel"))
        sd[t + "attn.proj.bias"] = _get(c, "attn/proj/bias")
        sd[t + "ls1.gamma"] = _get(c, "ls1/gamma")
        sd[t + "ls2.gamma"] = _get(c, "ls2/gamma")
        sd[t + "norm2.weight"] = _get(c, "norm2/scale")
        sd[t + "norm2.bias"] = _get(c, "norm2/bias")
        for name in (("w12", "w3") if "mlp_w12" in c else ("fc1", "fc2")):
            sd[t + f"mlp.{name}.weight"] = _lin(_get(c, f"mlp_{name}/kernel"))
            sd[t + f"mlp.{name}.bias"] = _get(c, f"mlp_{name}/bias")
    return _tensors(sd)


def _bn(sd: dict, p: dict, bs: dict, t: str) -> None:
    sd[t + "weight"] = _get(p, "scale")
    sd[t + "bias"] = _get(p, "bias")
    sd[t + "running_mean"] = _get(bs, "mean")
    sd[t + "running_var"] = _get(bs, "var")


def _conv_bn(sd: dict, p: dict, bs: dict, t_conv: str, t_bn: str) -> None:
    sd[t_conv + "weight"] = _conv(_get(p, "conv/kernel"))
    if "bias" in p["conv"]:
        sd[t_conv + "bias"] = _get(p, "conv/bias")
    _bn(sd, p["bn"], bs["bn"], t_bn)


def flax_to_torch_encoder(p: dict, bs: dict) -> dict:
    """JAX `FPNEncoder` params/batch_stats → the port's `FPNEncoder` state dict."""
    sd: dict = {}
    for name in ENCODER_BLOCKS:
        _conv_bn(sd, p[name], bs[name], f"{name}.conv.", f"{name}.bn.")
    return _tensors(sd)


def flax_to_torch_fpn_decoder(p: dict, bs: dict) -> dict:
    """JAX `FPNDecoder` params/batch_stats → the port's `FPNDecoder` state dict."""
    sd: dict = {}
    for name in DECODER_BLOCKS:
        _conv_bn(sd, p[name], bs[name], f"{name}.0.", f"{name}.1.")
    return _tensors(sd)


def _refine_block(sd: dict, p: dict, bs: dict, t: str) -> None:
    sd[t + "0.weight"] = _conv(_get(p, "dw/kernel"))
    sd[t + "0.bias"] = _get(p, "dw/bias")
    _bn(sd, p["bn"], bs["bn"], t + "1.")
    sd[t + "3.weight"] = _conv(_get(p, "pw/kernel"))
    sd[t + "3.bias"] = _get(p, "pw/bias")


def _index(tree, j: int):
    return {k: _index(v, j) for k, v in tree.items()} if isinstance(tree, dict) else np.asarray(tree)[j]


def flax_to_torch_refiner(p: dict, bs: dict) -> dict:
    """JAX `ConvRefiner` params/batch_stats → the port's `ConvRefiner` state
    dict; the scanned hidden blocks are unstacked."""
    sd = {"disp_emb.weight": _conv(_get(p, "disp_emb/kernel")),
          "disp_emb.bias": _get(p, "disp_emb/bias"),
          "out_conv.weight": _conv(_get(p, "out_conv/kernel")),
          "out_conv.bias": _get(p, "out_conv/bias")}
    _refine_block(sd, p["block1"], bs["block1"], "block1.")
    hp, hb = p["hidden"]["block"], bs["hidden"]["block"]
    for j in range(np.asarray(_get(hp, "dw/bias")).shape[0]):
        _refine_block(sd, _index(hp, j), _index(hb, j), f"hidden_blocks.{j}.")
    return _tensors(sd)


def flax_to_torch_head(head_vars: dict) -> dict:
    """JAX `GFNet` head variables {"params", "batch_stats"} → state dict of
    the port's `GFNet` (the reference checkpoint's key layout)."""
    p, bs = head_vars["params"], head_vars["batch_stats"]
    sd: dict = {}
    add = lambda part, prefix: sd.update({prefix + k: v for k, v in part.items()})
    add(flax_to_torch_crossview(p["crossview"]), "dino_decoder.")
    add(flax_to_torch_encoder(p["encoder"], bs["encoder"]), "encoder.")
    add(flax_to_torch_fpn_decoder(p["fpn_decoder"], bs["fpn_decoder"]), "decoder.")
    merge: dict = {}
    _conv_bn(merge, p["merge_layer"], bs["merge_layer"], "0.", "1.")
    add(_tensors(merge), "merge_layer.")
    for scale in SCALES:
        add(flax_to_torch_refiner(p[f"refiners_{scale}"], bs[f"refiners_{scale}"]),
            f"conv_refiner.{scale}.")
    return sd


def _nest(raw, skip: tuple[str, ...] = ()) -> dict:
    """A flat mapping with `/`-joined keys (an `.npz`) → nested dicts."""
    tree: dict = {}
    for name in raw.files:
        if name in skip:
            continue
        d = tree
        *parents, leaf = name.split("/")
        for k in parents:
            d = d.setdefault(k, {})
        d[leaf] = raw[name]
    return tree


def load_vit_npz(path: str) -> dict:
    """Read converted DINOv2 weights (the `.npz` the JAX package's
    `load_dinov2_params` reads) → state dict of the port's `VisionTransformer`."""
    with np.load(path) as raw:
        return flax_to_torch_vit(_nest(raw))


def load_head_npz(path: str) -> tuple[dict, bool]:
    """Read an `.npz` head (flat `params/...` and `batch_stats/...` keys, as
    `workspace/trained_head_*.npz`) → (port state dict, kv_norm). kv_norm is
    the `__protocol_kv_norm__` flag of heads trained with k/v
    standardization; the caller passes it to the config
    (`ModelConfig.with_kv_norm`)."""
    flag = "__protocol_kv_norm__"
    with np.load(path) as raw:
        kv_norm = bool(raw[flag]) if flag in raw.files else False
        return flax_to_torch_head(_nest(raw, skip=(flag,))), kv_norm
