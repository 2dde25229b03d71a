"""Decoder-only LM backbone of the port: the single-device half of the
JAX package's ``repro/models/transformer.py`` (training, prefill and
decode on one device).

Model features, switched per config as there: GQA, RoPE (partial,
interleaved pairs), qk-norm (qwen3), attention and final logit softcaps,
local/global alternation and sandwich norms (gemma2), tied or untied LM
head. Parameters keep the JAX package's tree: ``embed``, ``final_norm``,
``head`` (untied), and ``layers``, a dict of tensors stacked over layers
``(L, ...)``. They stay in ``param_dtype`` (fp32 by default; bf16 where
fp32 would not fit, as for moonshot at full width) and are cast to the
compute dtype one layer at a time, at the matmul, so no second full copy
exists.

Prefill attention is the hand-written flash-attention kernel
(``kernels/flash_attention``, one launch per layer); decode attention,
the projections, the FFN and the head are plain PyTorch, as they were
plain jnp outside any Pallas kernel in the JAX package. The KV cache is
updated in place by ``decode_step`` (the JAX version returns a new one):
at full width a second cache would not fit beside the first.

``forward_train`` is the training loss: the layers in train mode attend
through the plain, differentiable ``layers.blockwise_attention`` (the
JAX flash kernel is forward-only, and the JAX training step attends
through its jnp blockwise function too), each layer recomputed in the
backward where ``cfg.remat`` (``torch.utils.checkpoint``, the JAX
package's ``jax.checkpoint``), and the head ends in
``layers.chunked_softmax_xent``.

MoE layers (``models/moe.py``: f32 top-k routing, sort-based capacity
dispatch, per-expert SwiGLU) replace the dense FFN where ``cfg.moe``;
their router aux loss enters ``forward_train``'s loss, and ``prefill``
and ``decode_step`` drop it, as the JAX package's do. The early-fusion
stub projects ``patches`` into the first ``fused_patches`` positions.

Not ported yet (it raises ``NotImplementedError``): the device mesh
(context-parallel attention, sharded decode, expert parallelism;
ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_ffn, moe_init

_LOGIT_CHUNK = 32768  # vocab rows of the head cast to f32 at a time


def _unsupported(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh: not ported yet (ROADMAP.md, Queue 1: the LM's "
            "device mesh; the port runs LMs on one device)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator) -> dict:
    """The JAX package's parameter tree and init rule (normal with fan-in
    stddev, 0.02 for the embedding and head, zero norm scales), drawn from
    ``generator`` on its device. The numbers differ from the JAX package's
    (another generator): tests carry its weights over with
    ``repro_torch.convert.lm_params_from_repro``."""
    dtype = L.dt(cfg.param_dtype)
    dev = generator.device
    d, n = cfg.d_model, cfg.n_layers
    layers = {
        "ln1": L.rmsnorm_init(d, torch.float32, dev, stack=n),
        "ln2": L.rmsnorm_init(d, torch.float32, dev, stack=n),
        "wq": L.normal_init(generator, (d, cfg.q_dim), dtype, stack=n),
        "wk": L.normal_init(generator, (d, cfg.kv_dim), dtype, stack=n),
        "wv": L.normal_init(generator, (d, cfg.kv_dim), dtype, stack=n),
        "wo": L.normal_init(generator, (cfg.q_dim, d), dtype, stack=n),
    }
    if cfg.sandwich_norm:
        layers["ln1_post"] = L.rmsnorm_init(d, torch.float32, dev, stack=n)
        layers["ln2_post"] = L.rmsnorm_init(d, torch.float32, dev, stack=n)
    if cfg.qk_norm:
        layers["q_norm"] = L.rmsnorm_init(cfg.head_dim, torch.float32, dev,
                                          stack=n)
        layers["k_norm"] = L.rmsnorm_init(cfg.head_dim, torch.float32, dev,
                                          stack=n)
    if cfg.moe:
        layers["ffn"] = moe_init(generator, cfg, dtype, stack=n)
    else:
        layers["ffn"] = L.swiglu_init(generator, d, cfg.d_ff, dtype, stack=n)
    params = {
        "embed": L.normal_init(generator, (cfg.vocab_size, d), dtype,
                               stddev=0.02),
        "layers": layers,
        "final_norm": L.rmsnorm_init(d, torch.float32, dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.normal_init(generator, (cfg.vocab_size, d), dtype,
                                       stddev=0.02)
    if cfg.fused_patches:
        params["patch_proj"] = L.normal_init(generator, (cfg.patch_dim, d),
                                             dtype)
    return params


def layer_params(params, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tensors."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return pick(params["layers"])


def layer_windows(cfg) -> list:
    """Per-layer sliding window (0 = full/global attention)."""
    if cfg.layer_pattern == "local_global":
        # gemma2: even layers local (sliding window), odd layers global
        return [cfg.sliding_window if i % 2 == 0 else 0
                for i in range(cfg.n_layers)]
    return [0] * cfg.n_layers


# --------------------------------------------------------------------------
# attention sub-block
# --------------------------------------------------------------------------

def _qkv(p, xn, cfg, positions):
    cdt = L.dt(cfg.compute_dtype)
    B, S, _ = xn.shape
    xc = xn.to(cdt)
    q = (xc @ p["wq"].to(cdt)).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (xc @ p["wk"].to(cdt)).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (xc @ p["wv"].to(cdt)).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    inv_freq, rot_dim = L.rope_frequencies(cfg.head_dim, cfg.rotary_pct,
                                           cfg.rope_theta, xn.device)
    q = L.apply_rope(q, positions, inv_freq, rot_dim)
    k = L.apply_rope(k, positions, inv_freq, rot_dim)
    return q, k, v


def _attention(q, k, v, window: int, cfg):
    """Causal prefill attention over the whole prompt: the flash kernel
    (the function of the JAX package's ``_blockwise_traced_window``)."""
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True, window=window,
                           softcap=cfg.attn_softcap)


def _train_attention(q, k, v, window: int, cfg):
    """Causal training attention: the plain, differentiable blockwise
    function (the JAX package's ``_blockwise_traced_window``)."""
    return L.blockwise_attention(q, k, v, causal=True, window=window,
                                 softcap=cfg.attn_softcap,
                                 block_q=cfg.attn_block_q,
                                 block_kv=cfg.attn_block_kv)


# --------------------------------------------------------------------------
# one transformer layer (train / prefill / decode)
# --------------------------------------------------------------------------

def _layer(p, x, window: int, cfg, positions, mode, kv_cache=None,
           lengths=None):
    """Returns (x_out, aux, cache): ``aux`` is an MoE layer's router aux
    loss (None for a dense one). Prefill returns this layer's k, v as
    its cache; decode writes the new position into ``kv_cache`` (in place)
    at ``lengths`` and returns the cache; train returns none."""
    cdt = L.dt(cfg.compute_dtype)
    xn = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = _qkv(p, xn, cfg, positions)
    if mode == "train":
        new_cache = None
        attn = _train_attention(q, k, v, window, cfg)
    elif mode == "decode":
        # x: (B, 1, d); kv_cache: (k, v) each (B, S, KVH, D); lengths: (B,)
        k_cache, v_cache = kv_cache
        bidx = torch.arange(x.shape[0], device=x.device)
        k_cache[bidx, lengths] = k[:, 0].to(k_cache.dtype)
        v_cache[bidx, lengths] = v[:, 0].to(v_cache.dtype)
        new_cache = kv_cache
        attn = L.decode_attention(q[:, 0], k_cache, v_cache, lengths + 1,
                                  window=window,
                                  softcap=cfg.attn_softcap)[:, None]
    else:
        new_cache = (k, v)
        attn = _attention(q, k, v, window, cfg)

    B, S = x.shape[:2]
    attn = attn.reshape(B, S, cfg.q_dim).to(cdt)
    attn_out = (attn @ p["wo"].to(cdt)).to(x.dtype)
    if cfg.sandwich_norm:
        attn_out = L.rmsnorm(p["ln1_post"], attn_out, cfg.norm_eps)
    x = x + attn_out

    xn2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    aux = None
    if cfg.moe:
        ff, aux = moe_ffn(p["ffn"], xn2, cfg, cdt)
    else:
        ff = L.swiglu(p["ffn"], xn2, cdt).to(x.dtype)
    if cfg.sandwich_norm:
        ff = L.rmsnorm(p["ln2_post"], ff, cfg.norm_eps)
    return x + ff, aux, new_cache


# --------------------------------------------------------------------------
# embeddings, the head and the two serving entry points
# --------------------------------------------------------------------------

def embed_inputs(params, tokens, cfg, patches=None):
    """Token embeddings in the compute dtype; with ``cfg.fused_patches``
    and ``patches`` (B, P, patch_dim), their projection replaces the
    first ``fused_patches`` positions (the early-fusion stub)."""
    cdt = L.dt(cfg.compute_dtype)
    x = params["embed"][tokens].to(cdt)
    if cfg.sandwich_norm:  # gemma scales embeddings by sqrt(d), in cdt
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=x.device)
    if cfg.fused_patches and patches is not None:
        pe = patches.to(cdt) @ params["patch_proj"].to(cdt)
        x = torch.cat([pe, x[:, cfg.fused_patches:]], dim=1)
    return x


def _logits(params, x, cfg):
    """x: (B, d) after the final norm -> (B, V) f32 logits of the head cast
    to x's dtype (f32 sums of its products), final softcap applied. The
    head is cast a chunk of vocab rows at a time."""
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    xf = x.to(torch.float32)
    logits = torch.cat([
        xf @ head[i:i + _LOGIT_CHUNK].to(x.dtype).to(torch.float32).T
        for i in range(0, head.shape[0], _LOGIT_CHUNK)], dim=-1)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _train_layer(p, x, window: int, cfg, positions):
    x, aux, _ = _layer(p, x, window, cfg, positions, "train")
    return x, aux


def forward_train(params, batch, cfg, *, mesh=None):
    """The training loss. batch: tokens (B, S) int, targets (B, S) int,
    mask (B, S) f32, optional patches (B, P, patch_dim). Returns (loss,
    {"nll", "aux", "tokens"}): the masked mean next-token NLL of the
    head's f32 logits, plus the MoE layers' router aux losses, and the
    mask's weight. Each layer is recomputed in the backward where
    ``cfg.remat`` and autograd records."""
    _unsupported(mesh)
    tokens = batch["tokens"]
    S = tokens.shape[1]
    x = embed_inputs(params, tokens, cfg, batch.get("patches"))
    positions = torch.arange(S, device=x.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, window in enumerate(layer_windows(cfg)):
        args = (layer_params(params, i), x, window, cfg, positions)
        x, a = (checkpoint(_train_layer, *args, use_reentrant=False)
                if remat else _train_layer(*args))
        if a is not None:
            aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    head = params["embed"] if cfg.tie_embeddings else params["head"]
    loss_sum, weight = L.chunked_softmax_xent(
        x, head, batch["targets"], batch["mask"], softcap=cfg.final_softcap)
    nll = loss_sum / torch.clamp(weight, min=1.0)
    return nll + aux, {"nll": nll, "aux": aux, "tokens": weight}


def prefill(params, tokens, cfg, *, pad_to=None, mesh=None, patches=None):
    """Run the prompt (B, S) and build the KV cache. Returns (caches,
    last_logits (B, V) f32): caches (k, v) stacked over layers,
    (L, B, max(S, pad_to), KVH, D) in the compute dtype, zero past S.
    Logits are taken at the last position only. ``patches``: the
    early-fusion stub's inputs (``embed_inputs``)."""
    _unsupported(mesh)
    B, S = tokens.shape
    x = embed_inputs(params, tokens, cfg, patches)
    positions = torch.arange(S, device=x.device)[None, :]
    s_cache = max(S, pad_to or 0)
    shape = (cfg.n_layers, B, s_cache, cfg.n_kv_heads, cfg.head_dim)
    k_all = torch.zeros(shape, dtype=x.dtype, device=x.device)
    v_all = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, window in enumerate(layer_windows(cfg)):
        x, _, (k, v) = _layer(layer_params(params, i), x, window, cfg,
                              positions, "prefill")
        k_all[i, :, :S] = k
        v_all[i, :, :S] = v
    x = L.rmsnorm(params["final_norm"], x[:, -1], cfg.norm_eps)
    return (k_all, v_all), _logits(params, x, cfg)


def decode_step(params, caches, lengths, last_tokens, cfg, *, mesh=None):
    """One serving step: append ``last_tokens`` (B,) at ``lengths`` (B,) and
    predict the next token. Writes the caches in place; returns
    (caches, logits (B, V) f32)."""
    _unsupported(mesh)
    x = embed_inputs(params, last_tokens[:, None], cfg)
    positions = lengths[:, None]
    k_all, v_all = caches
    for i, window in enumerate(layer_windows(cfg)):
        x, _, _ = _layer(layer_params(params, i), x, window, cfg,
                         positions, "decode", kv_cache=(k_all[i], v_all[i]),
                         lengths=lengths)
    x = L.rmsnorm(params["final_norm"], x[:, 0], cfg.norm_eps)
    return caches, _logits(params, x, cfg)
