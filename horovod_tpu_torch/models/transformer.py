"""The decoder-only Transformer LM in PyTorch: training and serving.

Counterpart of ``horovod_tpu/models/transformer.py`` for the dense
model: parameters, the training forward and loss (:func:`forward`,
:func:`loss_fn`, :func:`synthetic_batch`; flash attention K1-K3 when
``attention_impl="flash"``), prefill, the contiguous-cache decode step
with the per-request :func:`sample_decode` / :func:`greedy_decode`
oracles, the per-slot sampler :func:`sample_token_rows` (JAX's threefry
draws, :mod:`~horovod_tpu_torch.ops.threefry`), and the paged decode
tick (paged-attention kernel K4 with ``kernel=True``).

Parameters are a plain dict in the JAX package's layout: layers stacked
on a leading ``L`` axis, the same names and shapes.  Every matrix is
cast to ``cfg.dtype`` at use, as in JAX, so the same code serves f32
master parameters (training: ``param_dtype=torch.float32``) and
matrices already held in ``cfg.dtype`` (serving's default, where the
casts are no-ops).  The RMSNorm scales stay f32.

Unlike JAX, tensors are mutable: caches and page pools are updated in
place (the JAX engine donates them to the same effect).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from horovod_tpu_torch.basics import resolve_device
from horovod_tpu_torch.ops import attention as attn
from horovod_tpu_torch.ops import paged_attention as pa
from horovod_tpu_torch.ops import threefry

__all__ = ["TransformerConfig", "decode_step", "decode_step_paged",
           "forward", "greedy_decode", "init_cache", "init_params",
           "kv_dequantize", "kv_quantize", "loss_fn", "prefill",
           "resolve_device", "sample_decode", "sample_token_rows",
           "synthetic_batch"]

_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq: int = 1024
    n_experts: int = 0  # 0/1 = dense MLP; MoE is not ported
    # Grouped-query attention: K/V heads (0 = n_heads, i.e. MHA).
    n_kv_heads: int = 0
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # "reference" = O(S^2) softmax attention; "flash" = kernels K1-K3.
    attention_impl: str = "reference"
    remat: bool = False  # rematerialisation is not ported

    def __post_init__(self):
        if self.n_experts > 1:
            raise NotImplementedError(
                "mixture-of-experts (n_experts > 1) is not ported")
        if self.remat:
            raise NotImplementedError(
                "rematerialisation (remat=True) is not ported")
        if self.attention_impl not in ("reference", "flash"):
            raise NotImplementedError(
                f"attention_impl {self.attention_impl!r} is not ported; "
                "expected 'reference' or 'flash' (the sequence-parallel "
                "impls come with a later slice)")
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be a multiple of n_heads")
        if self.n_heads % self.kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


# --- parameters --------------------------------------------------------------


def init_params(cfg: TransformerConfig, *, seed: int = 0, device=None,
                param_dtype: torch.dtype = None) -> Dict:
    """Random parameters in the JAX package's layout (``init_params``),
    drawn from a ``torch.Generator`` seeded with ``seed`` on ``device``
    (the numbers differ from ``jax.random``'s; :func:`~horovod_tpu_torch.
    models.convert.params_from_jax` carries the JAX package's own).

    Matrices are held in ``param_dtype``, by default ``cfg.dtype``
    (serving); training passes ``torch.float32`` for f32 master
    parameters, as the JAX package keeps."""
    device = resolve_device(device)
    param_dtype = param_dtype or cfg.dtype
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    D, H, Dh, Fd, L, V = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff,
                          cfg.n_layers, cfg.vocab_size)

    def normal(shape, scale):
        x = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32)
        return (x * scale).to(param_dtype)

    s_d, s_f = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    ones = dict(device=device, dtype=torch.float32)
    return {
        "embed": normal((V, D), 1.0),
        "layers": {
            "ln1": torch.ones((L, D), **ones),
            "ln2": torch.ones((L, D), **ones),
            "wq": normal((L, D, H, Dh), s_d),
            "wk": normal((L, D, cfg.kv_heads, Dh), s_d),
            "wv": normal((L, D, cfg.kv_heads, Dh), s_d),
            "wo": normal((L, H, Dh, D), s_d),
            "w_gate": normal((L, D, Fd), s_d),
            "w_up": normal((L, D, Fd), s_d),
            "w_down": normal((L, Fd, D), s_f),
        },
        "ln_f": torch.ones((D,), **ones),
        "head": normal((D, V), s_d),
    }


def _layer(params: Dict, l: int) -> Dict:
    return {k: v[l] for k, v in params["layers"].items()}


def _layers(params: Dict):
    """Every layer's parameter dict, from one ``unbind`` per stacked
    parameter: its gradient is one stack, not a full-size zero tensor
    per layer as indexing each layer would give."""
    names = list(params["layers"])
    per_name = [params["layers"][n].unbind(0) for n in names]
    return [dict(zip(names, vals)) for vals in zip(*per_name)]


# --- forward pieces ----------------------------------------------------------


def _rmsnorm(x, scale):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + 1e-6) * scale).to(x.dtype)


def _rope(q, k, theta: float, positions=None):
    """Rotary embedding over the head dim of ``(B, S, H, Dh)`` q and k,
    split into halves (not interleaved pairs), f32 angles.
    ``positions``: None = ``0..S-1``; else ``(B, S)`` per-row
    positions."""
    B, S, H, Dh = q.shape
    half = Dh // 2
    dev = q.device
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=dev) / half))
    pos = (positions.float() if positions is not None
           else torch.arange(S, dtype=torch.float32, device=dev))
    ang = pos[..., None] * freqs  # (S, half) or (B, S, half)
    if ang.dim() == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :]  # (1 | B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]

    def rot(x):
        # x (bf16) times f32 cos/sin promotes to f32, as in JAX.
        x1, x2 = x[..., :half], x[..., half:]
        xr1 = x1 * cos - x2 * sin
        xr2 = x2 * cos + x1 * sin
        return torch.cat([xr1, xr2], dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _qkv_proj(x, p, cfg: TransformerConfig, positions=None):
    """Per-head Q/K/V with RoPE -> head-major ``(B, H, S, Dh)`` /
    ``(B, H_kv, S, Dh)``."""
    dt = cfg.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    q, k = _rope(q, k, cfg.rope_theta, positions=positions)
    return (q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous())


def _out_proj(oh, p, cfg: TransformerConfig):
    o = oh.transpose(1, 2).to(cfg.dtype)  # (B, S, H, Dh)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(cfg.dtype))


def _dense_mlp(x, p, cfg: TransformerConfig):
    dt = cfg.dtype
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(dt))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["w_down"].to(dt))


def _mlp_block(x, p, cfg: TransformerConfig):
    """Residual MLP half of a layer (the dense branch of ``_mlp_block``)."""
    return x + _dense_mlp(_rmsnorm(x, p["ln2"]), p, cfg)


def _lm_head(y, ln_f, head, cfg: TransformerConfig):
    """Final RMSNorm + vocabulary projection -> f32 logits."""
    return torch.einsum("bsd,dv->bsv", _rmsnorm(y, ln_f),
                        head.to(cfg.dtype)).float()


def _embed(params, tokens, cfg: TransformerConfig, active=None):
    x = params["embed"].to(cfg.dtype)[tokens.long()]
    if active is not None:
        x = torch.where(active[:, None], x, torch.zeros_like(x))
    return x


# --- training forward and loss ----------------------------------------------


def _attention(x, p, cfg: TransformerConfig):
    """Full-sequence causal attention -> ``(output, K, V)``, K/V
    unexpanded and post-RoPE (prefill fills its cache with them).
    ``flash`` runs K1 forward and K2/K3 backward on CUDA, with GQA mapped
    in the kernels (no expanded K/V copy); ``reference`` expands K/V and
    differentiates the plain softmax."""
    qh, kh, vh = _qkv_proj(x, p, cfg)
    if cfg.attention_impl == "flash":
        oh = attn.flash_attention(qh, kh, vh, True)
    else:
        oh = attn.reference_attention(
            qh, attn.expand_kv(kh, cfg.n_heads),
            attn.expand_kv(vh, cfg.n_heads), causal=True)
    return _out_proj(oh, p, cfg), kh, vh


def _layer_body(x, p, cfg: TransformerConfig):
    x = x + _attention(_rmsnorm(x, p["ln1"]), p, cfg)[0]
    return _mlp_block(x, p, cfg)


def forward(params: Dict, tokens, cfg: TransformerConfig):
    """Logits ``(B, S, V)`` f32 for next-token prediction; ``tokens``
    ``(B, S)`` integer."""
    x = _embed(params, tokens, cfg)
    for p in _layers(params):
        x = _layer_body(x, p, cfg)
    return _lm_head(x, params["ln_f"], params["head"], cfg)


def _xent_sum(logits, targets):
    """Sum of next-token cross-entropy over all positions."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - gold).sum()


def loss_fn(params: Dict, batch: Dict, cfg: TransformerConfig):
    """Mean next-token cross-entropy; ``batch = {tokens, targets}``."""
    logits = forward(params, batch["tokens"], cfg)
    return _xent_sum(logits, batch["targets"]) / batch["targets"].numel()


def synthetic_batch(seed: int, cfg: TransformerConfig, batch: int,
                    seq: int = None, *, device=None) -> Dict:
    """Random tokens from a ``torch.Generator`` seeded with ``seed``, and
    their next-token targets ``roll(tokens, -1)`` (``synthetic_batch``)."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq or cfg.max_seq),
                           generator=g, device=device)
    return {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}


# --- prefill + the contiguous-cache oracle -----------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int = 0, *,
               device=None) -> Dict:
    """KV cache ``(L, B, H_kv, T, Dh)`` in ``cfg.dtype`` and a scalar
    position (a Python int, the write position of the next token)."""
    device = resolve_device(device)
    T = max_len or cfg.max_seq
    shape = (cfg.n_layers, batch, cfg.kv_heads, T, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": 0}




@torch.no_grad()
def prefill(params: Dict, prompt, cache: Dict, cfg: TransformerConfig, *,
            true_len=None):
    """Fill a FRESH cache with a ``(B, S0)`` prompt in one forward pass;
    returns ``(last-position logits (B, V), cache)``.  The cache's first
    ``S0`` positions are written in place.

    ``true_len`` supports bucketed prefill: prompts right-padded to
    ``S0`` with their real lengths, a scalar or a ``(B,)`` tensor —
    logits come from position ``true_len - 1`` of each row and ``pos``
    becomes ``true_len``.  Causality keeps the padding out of the
    logits; the junk K/V it leaves past ``true_len`` is never read."""
    if not isinstance(cache["pos"], int) or cache["pos"] != 0:
        raise ValueError("prefill requires a fresh cache (pos == 0)")
    B, S0 = prompt.shape
    if S0 > cache["k"].shape[3]:
        raise ValueError(
            f"prompt ({S0} tokens) exceeds cache capacity "
            f"({cache['k'].shape[3]}); init_cache with a larger max_len")
    x = _embed(params, prompt, cfg)
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h, kh, vh = _attention(_rmsnorm(x, p["ln1"]), p, cfg)
        cache["k"][l, :, :, :S0] = kh
        cache["v"][l, :, :, :S0] = vh
        x = _mlp_block(x + h, p, cfg)
    if true_len is None:
        last = x[:, -1:]
        new_pos = S0
    else:
        tl = torch.as_tensor(true_len, dtype=torch.long, device=x.device)
        idx = (tl - 1).expand(B) if tl.dim() == 0 else tl - 1
        last = x[torch.arange(B, device=x.device), idx][:, None]
        new_pos = int(tl) if tl.dim() == 0 else tl.to(torch.int32)
    logits = _lm_head(last, params["ln_f"], params["head"], cfg)
    cache["pos"] = new_pos
    return logits[:, 0], cache


def _cache_attend(qh, k_cache, v_cache, mask):
    """One query token per row against the full cache: products of the
    stored dtype accumulated in f32, GQA by grouping the queries.
    ``mask`` broadcasts to ``(B, H_kv, G, T)``; returns f32
    ``(B, H, 1, Dh)``."""
    B, H, _, Dh = qh.shape
    Hkv = k_cache.shape[1]
    qg = qh.reshape(B, Hkv, H // Hkv, Dh)
    s = torch.einsum("bkgd,bktd->bkgt", qg.to(k_cache.dtype).float(),
                     k_cache.float()) / math.sqrt(Dh)
    s = torch.where(mask, s, torch.full_like(s, attn.NEG_INF))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", w.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, H, 1, Dh)


def _attention_decode(x, p, cfg: TransformerConfig, k_cache, v_cache,
                      pos: int):
    """Write this position's K/V at ``pos`` (in place), attend q over
    positions ``<= pos``."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    qh, k_t, v_t = _qkv_proj(x, p, cfg, positions=positions)
    k_cache[:, :, pos] = k_t[:, :, 0]
    v_cache[:, :, pos] = v_t[:, :, 0]
    T = k_cache.shape[2]
    mask = torch.arange(T, device=x.device) <= pos
    o = _cache_attend(qh, k_cache, v_cache, mask)
    return _out_proj(o.to(cfg.dtype), p, cfg)


@torch.no_grad()
def decode_step(params: Dict, tokens_t, cache: Dict,
                cfg: TransformerConfig):
    """One autoregressive step at the cache's scalar position:
    ``tokens_t`` (B,) -> ``(logits (B, V) f32, cache)``, cache updated in
    place."""
    pos = int(cache["pos"])
    if pos >= cache["k"].shape[3]:
        raise ValueError(
            f"decode_step past cache capacity (pos {pos} >= "
            f"{cache['k'].shape[3]}); init_cache with a larger max_len")
    x = _embed(params, tokens_t, cfg)[:, None]
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = _attention_decode(_rmsnorm(x, p["ln1"]), p, cfg,
                              cache["k"][l], cache["v"][l], pos)
        x = _mlp_block(x + h, p, cfg)
    logits = _lm_head(x, params["ln_f"], params["head"], cfg)
    cache["pos"] = pos + 1
    return logits[:, 0], cache


def _softmax(x):
    """``jax.nn.softmax``'s arithmetic: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


@torch.no_grad()
def sample_token_rows(logits, temperature, top_k, top_p, rng, positions,
                      rows, *, margins: bool = False):
    """Pick one token per row with every sampling parameter as data: the
    serving tick's per-slot sampler and the math :func:`sample_decode`
    is defined by (``sample_token_rows`` of the JAX package).

    ``logits`` ``(R, V)`` f32.  ``temperature`` ``(R,)`` f32: ``<= 0`` is
    the greedy argmax of the raw logits.  ``top_k`` ``(R,)`` integer:
    ``> 0`` keeps the k largest scaled logits (the k-th value from a full
    descending sort, so k is data; ties with it stay).  ``top_p`` ``(R,)``
    f32: nucleus sampling after top-k — keep the smallest
    probability-sorted set whose mass reaches ``top_p``, ties at its
    threshold included (0 or >= 1 is off).  ``rng`` ``(R, 2)`` int64
    keys (:mod:`~horovod_tpu_torch.ops.threefry`), ``positions`` and
    ``rows`` ``(R,)`` integer: row ``r`` draws with
    ``fold_in(fold_in(rng[r], positions[r]), rows[r])``, so a key depends
    on the token's absolute position and never on how generation was
    sliced.  Returns int64 ``(R,)`` tokens; with ``margins=True`` also
    each pick's top-2 gap ``(R,)`` f32 of the scores it took the argmax
    of (raw logits for greedy rows, the filtered and perturbed scores
    for sampled rows), which tells a near-tie from a disagreement.

    Every operation is a tensor operation with no host sync: the tick
    captured as a CUDA graph runs it."""
    V = logits.shape[-1]
    sampled_row = temperature > 0.0
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.where(sampled_row, temperature,
                                  torch.ones_like(temperature))[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(srt, 1, (top_k.long().clamp(1, V) - 1)[:, None])
    scaled = scaled.masked_fill((top_k > 0)[:, None] & (scaled < kth),
                                float("-inf"))
    probs = _softmax(scaled)
    ps = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(ps, dim=-1)
    # Sorted index i is in the nucleus iff the mass before it is still
    # under top_p (index 0 always is); the smallest kept probability is
    # the threshold, so threshold ties stay in.
    keep = (csum - ps) < top_p[:, None]
    thr = ps.masked_fill(~keep, float("inf")).amin(dim=-1, keepdim=True)
    p_on = (top_p > 0.0) & (top_p < 1.0)
    scaled = scaled.masked_fill(p_on[:, None] & (probs < thr),
                                float("-inf"))
    keys = threefry.fold_in(threefry.fold_in(rng, positions), rows)
    perturbed = threefry.gumbel(keys, (V,)) + scaled
    tok = torch.where(sampled_row, torch.argmax(perturbed, dim=-1), greedy)
    if not margins:
        return tok
    top2 = torch.topk(torch.where(sampled_row[:, None], perturbed, logits),
                      2, dim=-1).values
    return tok, top2[:, 0] - top2[:, 1]


def _key_rows(rng, rows: int, device):
    """``(rows, 2)`` int64 keys from one raw key (2 uint32 words: a
    sequence, numpy array or tensor)."""
    if isinstance(rng, torch.Tensor):
        key = rng.to(device=device, dtype=torch.int64)
    else:
        key = torch.as_tensor(np.asarray(rng).astype(np.int64),
                              device=device)
    return key.reshape(1, 2).expand(rows, 2)


@torch.no_grad()
def sample_decode(params: Dict, prompt, steps: int, cfg: TransformerConfig,
                  *, rng, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 0.0, margins: bool = False):
    """Extend a ``(B, S0)`` prompt by ``steps`` sampled tokens ->
    ``(B, steps)`` int64: one prefill, then :func:`decode_step`s, each
    pick by :func:`sample_token_rows` with every parameter broadcast to a
    column — the per-request oracle of the serving engine's per-slot
    sampling.  ``temperature=0`` is greedy (:func:`greedy_decode`).

    ``rng`` is a raw key (``sampling.seed_key(seed)``, or JAX's
    ``np.asarray(jax.random.PRNGKey(seed))``).  Token ``i`` of row ``b``
    (position ``S0 + i``) draws from ``fold_in(fold_in(rng, S0 + i),
    b)``, so ``sample_decode(prompt + emitted, rng)`` continues exactly
    the stream an interrupted call would have produced.

    ``margins=True`` also returns each pick's top-2 gap ``(B, steps)``
    f32 (:func:`sample_token_rows`)."""
    B, S0 = prompt.shape
    dev = prompt.device
    cache = init_cache(cfg, B, S0 + steps, device=dev)
    logits, cache = prefill(params, prompt, cache, cfg)
    temp = torch.full((B,), float(temperature), dtype=torch.float32,
                      device=dev)
    tk = torch.full((B,), int(top_k), dtype=torch.int64, device=dev)
    tp = torch.full((B,), float(top_p), dtype=torch.float32, device=dev)
    keys = _key_rows(rng, B, dev)
    rows = torch.arange(B, device=dev)
    toks, gaps = [], []
    for i in range(steps):
        pos = torch.full((B,), S0 + i, dtype=torch.int64, device=dev)
        tok, gap = sample_token_rows(logits, temp, tk, tp, keys, pos, rows,
                                     margins=True)
        toks.append(tok)
        gaps.append(gap)
        if i + 1 < steps:
            logits, cache = decode_step(params, tok, cache, cfg)
    out = torch.stack(toks, dim=1)
    return (out, torch.stack(gaps, dim=1)) if margins else out


def greedy_decode(params: Dict, prompt, steps: int, cfg: TransformerConfig,
                  *, margins: bool = False):
    """Extend a ``(B, S0)`` prompt by ``steps`` greedy tokens ->
    ``(B, steps)`` int64: :func:`sample_decode` at temperature 0, the
    per-request oracle for the serving engine.  ``margins=True`` also
    returns each pick's top-2 logit gap ``(B, steps)`` f32, which tells a
    near-tie (where another summation order may pick the other token)
    from a real disagreement."""
    return sample_decode(params, prompt, steps, cfg, rng=(0, 0),
                         temperature=0.0, margins=margins)


# --- paged KV cache ----------------------------------------------------------


_KV_QUANT_EPS = 1e-8


def kv_quantize(x):
    """Symmetric per-vector int8 quantization over the trailing dim ->
    ``(q int8, scale f32)``.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp_min(_KV_QUANT_EPS) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q, scale, dtype):
    """Inverse of :func:`kv_quantize`: f32 multiply, then one cast (the
    kernel's load does the same — ``paged_attention.DEQUANT_COMPUTE``)."""
    return pa._dequant(q, scale, dtype)


def _gather_pages(pool_l, table):
    """``(P, H_kv, page, Dh)`` through ``(S, max_pages)`` ->
    ``(S, H_kv, max_pages * page, Dh)`` in logical order."""
    S, max_pages = table.shape
    _, Hkv, ps, Dh = pool_l.shape
    g = pool_l[table.long()]
    return g.movedim(1, 2).reshape(S, Hkv, max_pages * ps, Dh)


def _gather_scales(scale_l, table):
    S, max_pages = table.shape
    _, Hkv, ps = scale_l.shape
    g = scale_l[table.long()]
    return g.movedim(1, 2).reshape(S, Hkv, max_pages * ps)


def _attention_decode_paged(x, p, cfg: TransformerConfig, k_pool, v_pool,
                            k_scale, v_scale, table, pos, active,
                            kernel: bool):
    """Per-slot one-token attention against ONE layer's paged pool.

    Row ``s`` writes its K/V at logical position ``pos[s]``, i.e. page
    ``table[s, pos // page]`` offset ``pos % page`` — in place — then
    attends positions ``<= pos[s]``.  Inactive rows write to physical
    page 0, the NULL page: several of them share that target, and
    ``index_put_`` with duplicate indices leaves an unspecified winner —
    harmless only because no slot ever attends page 0 (its table maps
    real pages below its position, and the kernel's limit is 0 for
    inactive rows).  Active rows never collide: the host allocator gives
    every active slot a private write page.

    ``kernel=True`` attends through :func:`~horovod_tpu_torch.ops.
    paged_attention.paged_attend` (kernel K4 on CUDA); ``False`` gathers
    the logical cache, dequantizes and attends with the plain path."""
    S = x.shape[0]
    max_pages = table.shape[1]
    ps = k_pool.shape[2]
    qh, k_t, v_t = _qkv_proj(x, p, cfg, positions=pos[:, None])
    k_t1, v_t1 = k_t[:, :, 0], v_t[:, :, 0]       # (S, H_kv, Dh)
    rows = torch.arange(S, device=x.device)
    idx = torch.clamp(pos // ps, 0, max_pages - 1).long()
    phys = torch.where(active, table[rows, idx].long(),
                       torch.zeros_like(idx))
    off = (pos % ps).long()
    if k_scale is not None:
        qk, sk = kv_quantize(k_t1)
        qv, sv = kv_quantize(v_t1)
        k_pool[phys, :, off] = qk
        v_pool[phys, :, off] = qv
        k_scale[phys, :, off] = sk
        v_scale[phys, :, off] = sv
    else:
        k_pool[phys, :, off] = k_t1.to(k_pool.dtype)
        v_pool[phys, :, off] = v_t1.to(v_pool.dtype)
    B, H, _, Dh = qh.shape
    if kernel:
        # attend positions <= pos <=> logical < pos + 1; 0 for inactive
        # rows, whose NULL-page writes must never be attended.
        limit = torch.where(active, pos + 1, torch.zeros_like(pos))
        Hkv = k_pool.shape[1]
        qg = qh.reshape(B, Hkv, H // Hkv, Dh)
        o, _ = pa.paged_attend(qg, k_pool, v_pool, k_scale, v_scale, table,
                               limit.to(torch.int32), compute_dtype=cfg.dtype)
        o = o.reshape(B, H, 1, Dh)
    else:
        if k_scale is not None:
            kg = kv_dequantize(_gather_pages(k_pool, table),
                               _gather_scales(k_scale, table), cfg.dtype)
            vg = kv_dequantize(_gather_pages(v_pool, table),
                               _gather_scales(v_scale, table), cfg.dtype)
        else:
            kg = _gather_pages(k_pool, table)
            vg = _gather_pages(v_pool, table)
        T = max_pages * ps
        mask = torch.arange(T, device=x.device)[None, :] <= pos[:, None]
        o = _cache_attend(qh, kg, vg, mask[:, None, None, :])
    return _out_proj(o.to(cfg.dtype), p, cfg)


@torch.no_grad()
def decode_step_paged(params: Dict, tokens_t, pool: Dict, table,
                      cfg: TransformerConfig, active, *, kernel=False,
                      check_capacity: bool = True):
    """One continuous-batching decode tick over a PAGED KV cache.

    ``pool``: ``k``/``v`` ``(L, P, H_kv, page, Dh)`` (plus
    ``k_scale``/``v_scale`` ``(L, P, H_kv, page)`` for int8 storage) and
    per-slot ``pos`` ``(S,)`` int32; ``table``: ``(S, max_pages)`` int32
    page ids; ``active``: ``(S,)`` bool.  Returns ``logits (S, V)`` f32;
    the pool (payload, scales and ``pos``) is updated in place — ``pos``
    keeps its storage — and also returned.  Inactive rows compute on
    zeros and keep their position.

    ``check_capacity`` raises when an active slot's position is past its
    table; the check reads the device on the host.  The serving engine
    passes False: its host mirror of the positions has already proved
    capacity, and the tick must stay free of host syncs (for the
    overlapped pipeline and for CUDA-graph capture)."""
    pos = pool["pos"]
    T_cap = table.shape[1] * pool["k"].shape[3]
    if check_capacity:
        over = active & (pos >= T_cap)
        if bool(over.any()):
            raise ValueError(
                f"decode_step_paged past table capacity (slots "
                f"{torch.nonzero(over).flatten().tolist()} at pos >= "
                f"{T_cap}); init_page_pool with more pages per slot")
    x = _embed(params, tokens_t, cfg, active)[:, None]
    quantized = "k_scale" in pool
    for l in range(cfg.n_layers):
        p = _layer(params, l)
        h = _attention_decode_paged(
            _rmsnorm(x, p["ln1"]), p, cfg, pool["k"][l], pool["v"][l],
            pool["k_scale"][l] if quantized else None,
            pool["v_scale"][l] if quantized else None,
            table, pos, active, kernel)
        x = _mlp_block(x + h, p, cfg)
    logits = _lm_head(x, params["ln_f"], params["head"], cfg)
    pos.add_(active.to(pos.dtype))
    return logits[:, 0], pool
