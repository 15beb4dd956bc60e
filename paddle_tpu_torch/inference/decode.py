"""Autoregressive generation on the port: decode artifacts, the prefill /
decode phase split, the slot-table KV cache the serving layer batches
over (fp32 or int8), and speculative decoding.  The counterpart of
paddle_tpu/inference/decode.py (its single-device path), held against it
by tests/test_torch_*.py.

* A **decode artifact** is a directory with `decode_meta.bin` and
  `decode_state.bin` in the typed wire format.  `save_decode_model` and
  `build_tiny_decode_model` write the same bytes as the JAX package's, so
  one artifact serves both packages.
* **`CausalLM`** holds the artifact's weights as an `nn.Module` (a
  pre-LN causal LM with a learned position table and a 4 * d_model ReLU
  MLP) and runs the two phases: `prefill` pushes one padded prompt
  through causal attention and returns its K/V and first greedy token;
  `step` advances every slot of the table by one token through the
  hand-written decode-attention kernel (ops/pallas_kernels.py: K3 for
  fp32 caches, K4 for int8); `verify` scores a speculative chunk.
  `state_from_jax` carries the JAX package's parameter dict across,
  `kv_scales_from_jax` its int8 KV scales.
* **`DecodeSession`** is one slot table: K and V caches of shape
  [layers, n_slots, max_seq_len, heads, head_dim] on the predictor's
  device, updated IN PLACE by prefill, step, free and rollback.  A
  request owns one slot from prefill to finish; freeing a slot zeroes it,
  and a step writes back the old row of every slot it does not advance,
  so a dead slot stays exactly zero.
  Per-slot math is independent (row-wise matmuls, a per-slot kernel with
  no atomics), so at equal n_slots a batched stream is bit-exact against
  a single-request one.  With `kv_cache_dtype="int8"` the table is int8:
  per-(layer, head) scales calibrated on the CPU from the weights, every
  write quantized, attention dequantizing in registers.
* **`SpeculativeDecodeSession`** pairs the target with a draft predictor
  (its int8 twin, say): k draft steps propose, one target verify scores
  all k + 1 positions, and the longest agreeing prefix commits — a
  stream bit-identical to target-only greedy decode.
* **Fused N-step decode**: `DecodeSession.decode_fused` runs up to N
  steps in one dispatch and `SpeculativeDecodeSession.step(fused=True)`
  a whole round; on the card each is one CUDA graph, captured per
  session on first use and replayed (the port's form of the JAX
  package's `lax.while_loop` executables).  The steps are the same
  fixed-shape masked `CausalLM.step`, so the streams are bit-exact
  against the unfused ones.

Not ported yet: tensor-parallel lanes (`_TPContext`, the caller of K4's
head-slice entry), mesh replicas, the compile cache and the AOT export.

Sampling is greedy argmax (the first maximum, as in JAX).  Tokens and
lengths stay int32, as in the JAX package (x64 off).
"""

import os
import threading
import time
import warnings

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..flags import FLAGS
from ..native import wire
from ..ops.pallas_kernels import (KernelError, decode_attention,
                                  launch_counts)

__all__ = ["GenerativePredictor", "DecodeSession", "SpeculativeDecodeSession",
           "CausalLM", "save_decode_model", "build_tiny_decode_model",
           "load_decode_predictor", "greedy_decode", "set_draft_poison",
           "normalize_kv_dtype", "state_from_jax", "state_to_jax",
           "kv_scales_from_jax", "DECODE_META"]

DECODE_META = "decode_meta.bin"
_DECODE_STATE = "decode_state.bin"

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w1", "b1", "w2", "b2")

# chaos hook: once armed, the draft side of every SpeculativeDecodeSession
# raises after the given number of further draft steps — the in-process
# stand-in for a dead draft predictor.  The session must degrade to
# target-only decode within the same round, bit-exact.
_DRAFT_POISON = {"after": None, "steps": 0}


def set_draft_poison(after_steps=0):
    """Arm (int: the poison fires once `after_steps` more draft steps
    have run) or disarm (None) the draft-failure injection."""
    _DRAFT_POISON["after"] = None if after_steps is None \
        else int(after_steps)
    _DRAFT_POISON["steps"] = 0


def _check_draft_poison():
    after = _DRAFT_POISON["after"]
    if after is None:
        return
    _DRAFT_POISON["steps"] += 1
    if _DRAFT_POISON["steps"] > after:
        raise RuntimeError("chaos: draft predictor poisoned "
                           "(set_draft_poison)")


def normalize_kv_dtype(value):
    """Canonical KV-cache dtype: ''/None/'fp32'/'f32'/'float32' ->
    'float32', 'int8' -> 'int8'; anything else is a typed error."""
    v = str(value or "").strip().lower()
    if v in ("", "fp32", "f32", "float32"):
        return "float32"
    if v == "int8":
        return "int8"
    raise ValueError(
        "unsupported kv_cache_dtype %r (expected float32|int8)"
        % (value,))


def _default_prefill_buckets(max_seq_len):
    """Powers of two up to max_seq_len (min 8): the prompt-length
    buckets prefill pads to.  A pure function of the prompt length, so
    two decodes of the same prompt always run the same shapes — the
    bit-exactness contract leans on this."""
    buckets, b = [], 8
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(int(max_seq_len))
    return buckets


def save_decode_model(dirname, state, meta):
    """Write a decode artifact: `meta` (vocab_size, d_model, n_heads,
    n_layers, max_seq_len, eos_id, dtype, prefill_buckets) + `state`
    (the weight dict of numpy arrays) in the typed wire format."""
    os.makedirs(dirname, exist_ok=True)
    meta = dict(meta)
    meta.setdefault("arch", "causal_lm")
    meta.setdefault("version", 1)
    meta.setdefault("dtype", "float32")
    # only normalize a KV-cache pin the caller actually set: an artifact
    # with no pin defers to FLAGS.serving_kv_cache_dtype at open time
    if meta.get("kv_cache_dtype"):
        meta["kv_cache_dtype"] = normalize_kv_dtype(
            meta["kv_cache_dtype"])
    meta.setdefault("prefill_buckets",
                    _default_prefill_buckets(meta["max_seq_len"]))
    with open(os.path.join(dirname, _DECODE_STATE), "wb") as f:
        f.write(wire.encode({n: np.asarray(v) for n, v in state.items()}))
    with open(os.path.join(dirname, DECODE_META), "wb") as f:
        f.write(wire.encode(meta))
    return dirname


def build_tiny_decode_model(dirname, vocab_size=32, d_model=16,
                            n_heads=2, n_layers=2, max_seq_len=64,
                            eos_id=0, seed=7):
    """Deterministic random-weight causal LM artifact from numpy's
    RandomState(seed): same seed -> the byte-identical artifact the JAX
    package's `build_tiny_decode_model` writes."""
    if d_model % n_heads:
        raise ValueError("d_model %d not divisible by n_heads %d"
                         % (d_model, n_heads))
    rng = np.random.RandomState(seed)
    scale = 1.0 / np.sqrt(d_model)

    def w(*shape):
        return (rng.randn(*shape) * scale).astype(np.float32)

    state = {"embed": w(vocab_size, d_model),
             "pos": w(max_seq_len, d_model),
             "lnf_g": np.ones(d_model, np.float32),
             "lnf_b": np.zeros(d_model, np.float32),
             "lm_head": w(d_model, vocab_size)}
    for i in range(n_layers):
        p = "l%d_" % i
        state[p + "ln1_g"] = np.ones(d_model, np.float32)
        state[p + "ln1_b"] = np.zeros(d_model, np.float32)
        state[p + "wq"] = w(d_model, d_model)
        state[p + "wk"] = w(d_model, d_model)
        state[p + "wv"] = w(d_model, d_model)
        state[p + "wo"] = w(d_model, d_model)
        state[p + "ln2_g"] = np.ones(d_model, np.float32)
        state[p + "ln2_b"] = np.zeros(d_model, np.float32)
        state[p + "w1"] = w(d_model, 4 * d_model)
        state[p + "b1"] = np.zeros(4 * d_model, np.float32)
        state[p + "w2"] = w(4 * d_model, d_model)
        state[p + "b2"] = np.zeros(d_model, np.float32)
    meta = {"vocab_size": int(vocab_size), "d_model": int(d_model),
            "n_heads": int(n_heads), "n_layers": int(n_layers),
            "max_seq_len": int(max_seq_len), "eos_id": int(eos_id)}
    return save_decode_model(dirname, state, meta)


def _ln(x, g, b):
    """Layer norm with biased variance and eps 1e-5, in the JAX
    package's order of operations."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * g + b


def _causal_attention(q, k, v, scale):
    """Prefill attention: q/k/v [B, T, H, D] causal -> [B, T, H, D], with
    the kernels' finite -1e30 mask and 1e-20 normaliser floor."""
    T = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    idx = torch.arange(T, device=q.device)
    mask = idx[None, :] < idx[:, None] + 1
    s = s.masked_fill(~mask[None, None], -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()) \
        / torch.clamp_min(p.sum(dim=-1), 1e-20).transpose(1, 2)[..., None]


def _quantize_kv(x, scale):
    """Symmetric int8 quantization of fresh K/V rows against the
    calibrated per-head scale: clamp(round(x / scale), -127, 127) as
    exact integer values in fp32 (torch.round rounds half to even, as
    jnp.round does); the caller casts to int8."""
    return torch.clamp(torch.round(x / scale), -127.0, 127.0)


def _frozen(arr, device):
    return nn.Parameter(torch.tensor(np.asarray(arr), device=device),
                        requires_grad=False)


class _LayerNorm(nn.Module):
    def __init__(self, g, b, device):
        super().__init__()
        self.g = _frozen(g, device)
        self.b = _frozen(b, device)

    def forward(self, x):
        return _ln(x, self.g, self.b)


class _Block(nn.Module):
    """One pre-LN transformer layer: ln1, wq/wk/wv/wo, ln2, w1/b1/w2/b2."""

    def __init__(self, state, prefix, device):
        super().__init__()
        self.ln1 = _LayerNorm(state[prefix + "ln1_g"],
                              state[prefix + "ln1_b"], device)
        self.ln2 = _LayerNorm(state[prefix + "ln2_g"],
                              state[prefix + "ln2_b"], device)
        for key in _LAYER_KEYS:
            setattr(self, key, _frozen(state[prefix + key], device))

    def mlp_residual(self, x):
        # ReLU MLP; the residual adds the MLP output, then b2, in that
        # order (the JAX package's summation order)
        mlp = torch.relu(self.ln2(x) @ self.w1 + self.b1) @ self.w2
        return x + mlp + self.b2


class CausalLM(nn.Module):
    """The decode artifact's model: embed, pos, layers[i], lnf, lm_head.
    Frozen fp32 parameters on one device; `prefill` and `step` are the
    two phases of generation, `verify` the speculative decoder's scoring
    step.  With `kv_scales` set, every cache write is quantized to int8
    and attention runs K4."""

    def __init__(self, state, meta, device):
        super().__init__()
        self.n_layers = int(meta["n_layers"])
        self.n_heads = int(meta["n_heads"])
        self.d_model = int(meta["d_model"])
        self.head_dim = self.d_model // self.n_heads
        self.embed = _frozen(state["embed"], device)
        self.pos = _frozen(state["pos"], device)
        self.layers = nn.ModuleList(
            _Block(state, "l%d_" % i, device)
            for i in range(self.n_layers))
        self.lnf = _LayerNorm(state["lnf_g"], state["lnf_b"], device)
        self.lm_head = _frozen(state["lm_head"], device)
        self.attn_scale = 1.0 / np.sqrt(self.head_dim)
        # per-(layer, head) dequant scales [L, 2, H] of an int8 slot
        # table (K row 0, V row 1); None for a float32 cache
        self.kv_scales = None

    @torch.no_grad()
    def forward(self, tokens):
        """The causal forward over tokens [1, B] int64 -> (final hidden
        states [1, B, D] before lnf, per-layer K and V [1, B, H, Dh])."""
        H, Dh = self.n_heads, self.head_dim
        B = tokens.shape[1]
        scale = 1.0 / np.sqrt(Dh)
        x = self.embed[tokens] + self.pos[:B][None]
        ks, vs = [], []
        for layer in self.layers:
            h = layer.ln1(x)
            q = (h @ layer.wq).reshape(1, B, H, Dh)
            k = (h @ layer.wk).reshape(1, B, H, Dh)
            v = (h @ layer.wv).reshape(1, B, H, Dh)
            att = _causal_attention(q, k, v, scale).reshape(1, B, H * Dh)
            x = x + att @ layer.wo
            x = layer.mlp_residual(x)
            ks.append(k)
            vs.append(v)
        return x, ks, vs

    # -- the int8 KV cache ----------------------------------------------

    def _to_cache(self, rows, layer, which):
        """Fresh K (which=0) or V (1) rows [..., H, Dh] in the cache's
        numerics: as they are for a float32 cache, quantized against the
        layer's per-head scales for an int8 one."""
        if self.kv_scales is None:
            return rows
        return _quantize_kv(rows, self.kv_scales[layer, which][:, None]) \
            .to(torch.int8)

    def _attention_scales(self, layer):
        """The layer's [2, H] dequant scales for K4; None for float32."""
        return None if self.kv_scales is None else self.kv_scales[layer]

    # -- the phases -----------------------------------------------------

    @torch.no_grad()
    def prefill(self, tokens, true_len):
        """tokens [1, B] int64 (a prompt padded to its bucket), true_len
        int -> (first token [] int32, k/v [L, 1, B, H, Dh] with the pad
        positions zeroed: fp32, or quantized to int8 under `kv_scales`)."""
        B = tokens.shape[1]
        x, ks, vs = self(tokens)
        # only the last live position's logits pick the first token
        logits = self.lnf(x[0, true_len - 1]) @ self.lm_head
        first = torch.argmax(logits, dim=-1).to(torch.int32)
        # the slot cache holds exact zeros past the live length (zeros
        # quantize to exact int8 zeros)
        live = (torch.arange(B, device=x.device) < true_len)[
            None, None, :, None, None]
        kc = torch.where(live, torch.stack(ks), 0.0)
        vc = torch.where(live, torch.stack(vs), 0.0)
        if self.kv_scales is not None:
            sc = self.kv_scales[:, :, None, None, :, None]  # [L,2,1,1,H,1]
            kc = _quantize_kv(kc, sc[:, 0]).to(torch.int8)
            vc = _quantize_kv(vc, sc[:, 1]).to(torch.int8)
        return first, kc, vc

    def _qkv(self, layer, x):
        """One layer's projections of x [N, D] -> q, k, v [N, H, Dh]."""
        N = x.shape[0]
        h = layer.ln1(x)
        return tuple((h @ w).reshape(N, self.n_heads, self.head_dim)
                     for w in (layer.wq, layer.wk, layer.wv))

    def _after_attention(self, layer, x, att):
        """x [N, D] + the attention output [N, D] through wo, then the
        MLP residual."""
        x = x + att @ layer.wo
        return layer.mlp_residual(x)

    def _greedy(self, x):
        return torch.argmax(self.lnf(x) @ self.lm_head, dim=-1).to(
            torch.int32)

    @torch.no_grad()
    def step(self, kc, vc, lengths, last_tokens, running):
        """One decode step over the whole slot table at fixed shapes (the
        counterpart of paddle_tpu's `_step_math`).  kc/vc [L, N, S, H, Dh]
        caches (fp32, or int8 under `kv_scales`), UPDATED IN PLACE;
        lengths [N] int64 (live cached positions), last_tokens [N] int64,
        running [N] bool (the slots this step advances) -> new tokens [N]
        int32.

        Every slot's new K/V row goes to position lengths[n] (clamped to
        S - 1) before attention, which then covers lengths + 1 positions
        (write before attend); under int8 the row is quantized first.  A
        slot that is not running, or whose cache is full, gets its old
        row written back, so a dead slot stays exactly zero.  No shape
        depends on which slots run, so the step can be captured in a CUDA
        graph and replayed for any running set."""
        N, S = kc.shape[1], kc.shape[2]
        pos = torch.clamp(lengths, max=S - 1)
        x = self.embed[last_tokens] + self.pos[pos]
        flat = torch.arange(N, device=pos.device) * S + pos
        write = (running & (lengths < S))[:, None, None]
        # every layer's rows at the write positions, read once: each is
        # written once in this step, by its own layer
        old_k = _flat(kc).index_select(1, flat)
        old_v = _flat(vc).index_select(1, flat)
        att_lengths = (lengths + 1).to(torch.int32)
        for i, layer in enumerate(self.layers):
            q, k_new, v_new = self._qkv(layer, x)
            _flat(kc)[i].index_copy_(0, flat, torch.where(
                write, self._to_cache(k_new, i, 0), old_k[i]))
            _flat(vc)[i].index_copy_(0, flat, torch.where(
                write, self._to_cache(v_new, i, 1), old_v[i]))
            att = decode_attention(q, kc[i], vc[i], att_lengths,
                                   scale=self.attn_scale,
                                   kv_scales=self._attention_scales(i))
            x = self._after_attention(layer, x, att.reshape(N, self.d_model))
        return self._greedy(x)

    @torch.no_grad()
    def verify(self, kc, vc, lengths, tokens, running):
        """One speculative verify step over the whole slot table (the
        counterpart of paddle_tpu's `_verify_math`): tokens [N, C] int64 =
        [pending token, drafts d1..dk] (C = k + 1), lengths [N] int64,
        running [N] bool (the slots verified; each needs >= C rows of
        room) -> (g [N, C] int32, the target's greedy token after each
        chunk position; m [N] int32, the accepted draft count 0..k).
        The caches are updated in place, at fixed shapes as in `step`.

        Chunk position j of slot n rounds exactly like the plain step
        that would consume token j there: its embedding, projections,
        MLP and logits run at the step's own [N, D] shapes (C passes per
        layer — a batched [N * C, D] product may sum in another order on
        the card), its K/V row is written before attention (quantized
        under int8, the step's bytes), and it attends as a pseudo-slot
        of length lengths + j + 1 through the same kernel — one K3/K4
        launch per layer over the N * C pseudo-slots, reading the slot's
        cache in place (q_per_slot = C).  So a draft that proposes the
        target's own tokens is accepted whole, and every committed token
        equals target-only greedy decode.

        Acceptance is computed here: m is the longest prefix with d_i ==
        g_{i-1}.  Rows this step wrote past lengths + m + 1 (the rejected
        suffix) are zeroed before returning, so stale draft K/V never
        survives into the committed cache.  Slots not running keep their
        bytes: each write and the zeroing select the old row where they
        do not apply."""
        N, C = tokens.shape
        S = kc.shape[2]
        dev = tokens.device
        steps = torch.arange(C, device=dev)
        at = lengths[:, None] + steps[None]
        pos = torch.clamp(at, max=S - 1)
        base = torch.arange(N, device=dev)[:, None] * S
        flat = base + pos                                           # [N, C]
        write = (running[:, None] & (at < S))[:, :, None, None]
        old_k = _flat(kc).index_select(1, flat.reshape(-1)).unflatten(
            1, (N, C))
        old_v = _flat(vc).index_select(1, flat.reshape(-1)).unflatten(
            1, (N, C))
        xs = [self.embed[tokens[:, j]] + self.pos[pos[:, j]]
              for j in range(C)]
        q_lengths = (at + 1).reshape(N * C).to(torch.int32)
        for i, layer in enumerate(self.layers):
            qs = []
            for j, x in enumerate(xs):
                q, k_new, v_new = self._qkv(layer, x)
                _flat(kc)[i].index_copy_(0, flat[:, j], torch.where(
                    write[:, j], self._to_cache(k_new, i, 0), old_k[i, :, j]))
                _flat(vc)[i].index_copy_(0, flat[:, j], torch.where(
                    write[:, j], self._to_cache(v_new, i, 1), old_v[i, :, j]))
                qs.append(q)
            q = torch.stack(qs, dim=1).reshape(N * C, self.n_heads,
                                               self.head_dim)
            att = decode_attention(q, kc[i], vc[i], q_lengths,
                                   scale=self.attn_scale,
                                   kv_scales=self._attention_scales(i),
                                   q_per_slot=C).reshape(N, C, self.d_model)
            xs = [self._after_attention(layer, x, att[:, j].contiguous())
                  for j, x in enumerate(xs)]
        g = torch.stack([self._greedy(x) for x in xs], dim=1)
        match = (tokens[:, 1:] == g[:, :C - 1]).to(torch.int32)
        m = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
        # the rejected suffix: chunk rows j > m of the written slots (at
        # positions taken mod S, distinct within every slot)
        stale = write[:, 1:, 0, 0] & (steps[None, 1:] > m[:, None])
        _zero_rows(kc, vc, base + (at[:, 1:] % S), stale)
        return g, m


def _flat(cache):
    """A cache [L, N, S, H, Dh] as rows [L, N * S, H, Dh] (a view): row
    slot * S + position."""
    return cache.view(cache.shape[0], -1, *cache.shape[-2:])


def _zero_rows(kc, vc, flat, zero):
    """Zero, in every layer of both caches, the rows at the flat
    positions `flat` (no position twice) where `zero` (flat's shape) is
    true; the other rows are written back as they are."""
    flat, mask = flat.reshape(-1), zero.reshape(1, -1, 1, 1)
    for cache in (kc, vc):
        rows = _flat(cache)
        rows.index_copy_(1, flat, rows.index_select(1, flat).masked_fill(
            mask, 0))


def _fused_window(model, kc, vc, ins, n_steps, eos, early_exit):
    """The fused decode window (paddle_tpu's `_fused_step_math`): up to
    `n_steps` trips of the masked `CausalLM.step` with the per-trip
    bookkeeping, over caches kc/vc [L, N, S, H, Dh] updated in place.
    ins [4N + 1] int32 packs lengths, last tokens, active, budget and
    max_trips; returns the packed int32 [N * n_steps + 3N + 1]: tokens
    [N, n_steps], counts [N], trips, lengths [N], last tokens [N].

    A slot runs while it has emitted fewer than its budget, has not
    emitted EOS and has cache room; trip i runs the running slots only
    while i < max_trips, so one window serves every clamp.  With
    `early_exit` (the eager plain version) the loop ends once no slot
    runs; without it (the CUDA graph) the remaining trips run fully
    masked and write nothing.  `trips` counts the trips in which some
    slot ran, as paddle_tpu's while_loop does."""
    N, S = kc.shape[1], kc.shape[2]
    v = ins.long()
    start, last = v[:N], v[N:2 * N]
    # a slot runs from trip 0 without a gap, so the trips in which some
    # slot ran are the most tokens a slot emitted
    limit = torch.clamp(start + v[3 * N:4 * N], max=S)
    running = (v[2 * N:3 * N] != 0) & (start < limit)
    allowed = torch.arange(n_steps, device=v.device) < v[4 * N]
    lengths, toks = start, []
    for i in range(n_steps):
        run = running & allowed[i]
        if early_exit and not bool(run.any()):
            break
        tok = model.step(kc, vc, lengths, last, run).long()
        toks.append(torch.where(run, tok, 0))
        lengths = lengths + run
        last = torch.where(run, tok, last)
        running = run & (tok != eos) & (lengths < limit)
    toks += [torch.zeros_like(start)] * (n_steps - len(toks))
    emitted = lengths - start
    return torch.cat([torch.stack(toks, dim=1).reshape(-1), emitted,
                      emitted.max().reshape(1), lengths, last]).to(
                          torch.int32)


def _spec_window(target, draft, t_kc, t_vc, d_kc, d_vc, ins, k):
    """The fused speculative round (paddle_tpu's `_fused_spec_math`): k
    masked draft steps, the masked verify with its accept count, the
    target commit, the draft rollback and the catch-up draft step, over
    the target's and the draft's caches (updated in place).  ins [5N]
    int32 packs the target's lengths and last tokens, the draft's, and
    active; returns the packed int32 [N (k + 1) + 5N]: g [N, k + 1], m
    [N], then the four updated vectors in the same order.

    Every part is the host-driven round's math at its shapes: the draft
    steps and the catch-up are `CausalLM.step`, the verify is
    `CausalLM.verify`, and the rollback zeroes the rows [d_len - nback,
    d_len) of each partially accepted slot, nback = k - 1 - m, as
    `DecodeSession.rollback` does — at most k - 1 fixed rows a slot
    (positions taken mod S, so none twice), in one pass."""
    N, Sd = d_kc.shape[1], d_kc.shape[2]
    v = ins.long()
    t_len, t_last, d_len, d_last = (v[i * N:(i + 1) * N] for i in range(4))
    active = v[4 * N:] != 0
    adv = active.long()
    drafts = []
    for _ in range(k):
        tok = draft.step(d_kc, d_vc, d_len, d_last, active).long()
        d_len = d_len + adv
        d_last = torch.where(active, tok, d_last)
        drafts.append(tok)
    g, m = target.verify(t_kc, t_vc, t_len,
                         torch.stack([t_last] + drafts, dim=1), active)
    g = g.long()
    m = torch.where(active, m.long(), 0)
    pick = g.gather(1, torch.clamp(m, max=k)[:, None])[:, 0]
    t_len = t_len + torch.where(active, m + 1, 0)
    t_last = torch.where(active, pick, t_last)
    # partially accepted slots roll the draft's rejected rows back and
    # re-pin its pending token to the target's correction...
    part = active & (m < k)
    nback = torch.where(part, k - 1 - m, 0)
    back = torch.arange(1, k, device=v.device)[None]
    _zero_rows(d_kc, d_vc, (torch.arange(N, device=v.device) * Sd)[:, None]
               + (d_len[:, None] - back) % Sd, nback[:, None] >= back)
    d_len = d_len - nback
    d_last = torch.where(part, pick, d_last)
    # ...and fully accepted ones owe the draft one catch-up step (it
    # proposed d_k without consuming it), pinned to the bonus token
    full = active & (m == k)
    draft.step(d_kc, d_vc, d_len, d_last, full)
    d_len = d_len + full.long()
    d_last = torch.where(full, g[:, k], d_last)
    return torch.cat([g.reshape(-1), m, t_len, t_last, d_len, d_last]).to(
        torch.int32)


class _CapturedWindow:
    """A window captured once as a CUDA graph over a session's own
    caches, then replayed: one host-to-device copy of the packed int32
    inputs, one graph launch, one device-to-host copy of the packed
    outputs and one sync per window.

    `body(ins)` computes the window from the static input buffer `ins`
    and returns its packed int32 outputs.  Before capture it runs once on
    a side stream with the inputs zeroed (no slot active, so it writes
    nothing): that builds the kernels and sets up cuBLAS on the stream;
    its launches are real and stay counted (`warmup`).  Capture runs no
    kernel, so the launches the kernel wrappers counted during capture
    are taken back from `launch_counts` and added again on every replay
    (`launches`, per replay).  A failed capture or replay raises;
    nothing falls back to the eager loop."""

    def __init__(self, device, n_in, body):
        with torch.cuda.device(device):
            self.ins = torch.zeros(n_in, dtype=torch.int32, device=device)
            self.host_in = torch.zeros(n_in, dtype=torch.int32,
                                       pin_memory=True)
            self.stream = torch.cuda.Stream(device)
            self.stream.wait_stream(torch.cuda.current_stream(device))
            before = dict(launch_counts)
            with torch.cuda.stream(self.stream):
                body(self.ins)
            self.stream.synchronize()
            self.warmup = _count_delta(before)
            before = dict(launch_counts)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                self.outs = body(self.ins)
        self.launches = _count_delta(before)
        for name, n in self.launches.items():
            launch_counts[name] -= n
        self.host_out = torch.empty(self.outs.shape, dtype=torch.int32,
                                    pin_memory=True)
        self.replays = 0

    def run(self, ins):
        """Replay on the packed inputs `ins` (numpy int32); returns the
        packed outputs as numpy int32."""
        self.host_in.numpy()[:] = ins
        self.ins.copy_(self.host_in, non_blocking=True)
        self.graph.replay()
        self.host_out.copy_(self.outs, non_blocking=True)
        torch.cuda.current_stream(self.ins.device).synchronize()
        for name, n in self.launches.items():
            launch_counts[name] += n
        self.replays += 1
        return self.host_out.numpy().copy()

    def stats(self):
        return {"replays": self.replays, "launches": dict(self.launches),
                "warmup": dict(self.warmup)}


def _count_delta(before):
    """The kernel launches counted since the snapshot `before`."""
    return {name: launch_counts[name] - n for name, n in before.items()
            if launch_counts[name] != n}


def state_from_jax(state_np, meta, device):
    """The JAX package's decode parameter dict (numpy arrays keyed
    embed/pos/lnf_*/lm_head/l{i}_*, as `GenerativePredictor._state_host`
    or a decoded `decode_state.bin` holds it) as a `CausalLM` on
    `device`."""
    return CausalLM(state_np, meta, resolve_device(device))


def kv_scales_from_jax(predictor, scales):
    """Install the JAX package's int8 KV scales (its predictor's
    `kv_scales()`, [2, L, H]) into an int8 port `predictor`, beside the
    weights `state_from_jax` carries: the two packages calibrate through
    differently rounded prefills, and equal scales make their int8
    caches comparable byte for byte."""
    if predictor.kv_cache_dtype != "int8":
        raise ValueError("kv_scales_from_jax: the predictor's cache is %s, "
                         "not int8" % predictor.kv_cache_dtype)
    predictor._set_kv_scales(scales)
    return predictor


def state_to_jax(model):
    """The inverse of `state_from_jax`: the model's parameters as the JAX
    package's numpy dict, in the artifact's key order."""
    out = {"embed": model.embed, "pos": model.pos,
           "lnf_g": model.lnf.g, "lnf_b": model.lnf.b,
           "lm_head": model.lm_head}
    for i, layer in enumerate(model.layers):
        p = "l%d_" % i
        out[p + "ln1_g"] = layer.ln1.g
        out[p + "ln1_b"] = layer.ln1.b
        for key in _LAYER_KEYS[:4]:
            out[p + key] = getattr(layer, key)
        out[p + "ln2_g"] = layer.ln2.g
        out[p + "ln2_b"] = layer.ln2.b
        for key in _LAYER_KEYS[4:]:
            out[p + key] = getattr(layer, key)
    return {k: v.detach().cpu().numpy() for k, v in out.items()}


class GenerativePredictor:
    """A decode artifact opened for serving on one device: the meta
    surface, the `CausalLM` weights, and the two phases.  `device=None`
    means "cuda" (raising when CUDA is absent).

    `kv_cache_dtype` picks the cache numerics per open (explicit arg >
    the artifact's decode_meta pin > FLAGS.serving_kv_cache_dtype >
    float32).  'int8' calibrates per-(layer, head) scales once, on the
    CPU from the artifact's weights, so they are a function of the
    artifact alone (equal on the card and the CPU, and for every
    reopen); every session this predictor vends then quantizes its cache
    writes and attends through K4."""

    # the serving registry fronts a decode artifact with a DecodeBatcher
    is_decode = True

    def __init__(self, dirname, device=None, kv_cache_dtype=None):
        self._dirname = dirname
        self._device = resolve_device(device)
        with open(os.path.join(dirname, DECODE_META), "rb") as f:
            self.meta = wire.decode(f.read())
        if kv_cache_dtype is not None:
            kv = normalize_kv_dtype(kv_cache_dtype)
        elif self.meta.get("kv_cache_dtype"):
            kv = normalize_kv_dtype(self.meta["kv_cache_dtype"])
        else:
            kv = normalize_kv_dtype(FLAGS.serving_kv_cache_dtype)
        self._kv_dtype = kv
        with open(os.path.join(dirname, _DECODE_STATE), "rb") as f:
            state = wire.decode(f.read())
        self.model = state_from_jax(state, self.meta, self._device)
        self._kv_scales = None
        if kv == "int8":
            self._set_kv_scales(self._calibrate_kv_scales(state))
        self._lock = threading.Lock()
        # prompt lengths past every bucket that have already warned
        self._overflow_warned = set()

    # -- meta surface ---------------------------------------------------

    @property
    def device(self):
        return self._device

    @property
    def vocab_size(self):
        return int(self.meta["vocab_size"])

    @property
    def max_seq_len(self):
        return int(self.meta["max_seq_len"])

    @property
    def eos_id(self):
        return int(self.meta["eos_id"])

    @property
    def kv_cache_dtype(self):
        return self._kv_dtype

    def prefill_buckets(self):
        return tuple(int(b) for b in self.meta["prefill_buckets"])

    def batch_buckets(self):
        """The serving introspection of a Predictor: a decode model's
        buckets are its prompt-length prefill buckets."""
        return self.prefill_buckets()

    def prompt_bucket(self, prompt_len):
        """Smallest prefill bucket >= prompt_len (a pure function of the
        length — the parity contract rides this).  A prompt past every
        bucket but inside the cache prefills at its exact length, warning
        once per such length."""
        buckets = self.prefill_buckets()
        for b in buckets:
            if prompt_len <= b:
                return b
        if prompt_len > self.max_seq_len:
            raise ValueError(
                "prompt of %d tokens exceeds max_seq_len %d"
                % (prompt_len, self.max_seq_len))
        with self._lock:
            first = prompt_len not in self._overflow_warned
            self._overflow_warned.add(prompt_len)
        if first:
            warnings.warn(
                "prompt of %d tokens exceeds every configured prefill "
                "bucket %s on device [%s] — prefilling at its exact "
                "length; extend prefill_buckets to keep prefill shapes "
                "to a fixed set" % (prompt_len, tuple(buckets),
                                    self._device),
                RuntimeWarning, stacklevel=3)
        return int(prompt_len)

    def check_tokens(self, tokens):
        """Raise on token ids outside [0, vocab_size).  JAX clamps an
        out-of-range gather; on the card it would be a device-side fault
        that ends the process's CUDA context, so ids are checked on the
        host first."""
        tokens = np.asarray(tokens)
        if tokens.size and (tokens.min() < 0
                            or tokens.max() >= self.vocab_size):
            raise ValueError("token ids must lie in [0, %d), got %d..%d"
                             % (self.vocab_size, tokens.min(),
                                tokens.max()))

    def _dims(self):
        m = self.meta
        return (int(m["n_layers"]), int(m["n_heads"]),
                int(m["d_model"]) // int(m["n_heads"]),
                int(m["d_model"]))

    def kv_cache_bytes(self, n_slots):
        """Closed-form slot-table footprint: K and V, [L, n_slots, S, H,
        Dh] each at the cache dtype's width (4 B fp32, 1 B int8), plus
        the int8 cache's per-(layer, head) fp32 scale table."""
        L, H, Dh, _ = self._dims()
        quant = self._kv_dtype == "int8"
        return (2 * L * int(n_slots) * self.max_seq_len * H * Dh
                * (1 if quant else 4) + (2 * L * H * 4 if quant else 0))

    # -- the int8 KV cache ----------------------------------------------

    def _calibrate_kv_scales(self, state):
        """Per-(layer, head) symmetric scales for the int8 KV cache: amax
        of |K| / |V| over a deterministic vocab-cycling probe prompt run
        through the fp32 prefill on the CPU from the artifact's weights,
        x1.25 headroom for decode-time rows the probe never saw, /127.
        Returns [2, L, H] float32 (K row 0, V row 1)."""
        T = int(min(self.max_seq_len - 1, 64))
        vocab = max(self.vocab_size, 1)
        tokens = (np.arange(T, dtype=np.int64) * 7 + 1) % vocab
        host = CausalLM(state, self.meta, torch.device("cpu"))
        _, kc, vc = host.prefill(torch.from_numpy(tokens).reshape(1, T), T)

        def sc(x):
            amax = np.abs(x.numpy()).max(axis=(1, 2, 4))   # [L, H]
            return (np.maximum(amax, 1e-6) * 1.25
                    / 127.0).astype(np.float32)

        return np.stack([sc(kc), sc(vc)])

    def _set_kv_scales(self, scales):
        L, H, _, _ = self._dims()
        scales = np.asarray(scales, np.float32).reshape(2, L, H)
        self._kv_scales = scales
        self.model.kv_scales = torch.from_numpy(
            np.ascontiguousarray(scales.transpose(1, 0, 2))).to(self._device)

    def kv_scales(self):
        """The calibrated per-(layer, head) fp32 dequant scales [2, L, H]
        (K row 0, V row 1); None for a float32 cache."""
        return None if self._kv_scales is None else self._kv_scales.copy()

    def param_bytes(self):
        """Static weight footprint."""
        return sum(p.numel() * p.element_size()
                   for p in self.model.parameters())

    # -- phases ---------------------------------------------------------

    def prefill(self, padded, true_len):
        """padded [1, B] int32 host tokens, true_len int -> (first token
        int, k/v [L, 1, B, H, Dh] on the device, in the cache dtype)."""
        tokens = torch.from_numpy(
            np.asarray(padded, np.int64)).to(self._device)
        first, kc, vc = self.model.prefill(tokens, int(true_len))
        return int(first), kc, vc

    def new_session(self, n_slots):
        return DecodeSession(self, n_slots)

    def clone_to(self, device):
        """A replica of this artifact on `device` with the same cache
        numerics (its int8 scales are a function of the artifact alone,
        so every replica's are equal)."""
        return GenerativePredictor(self._dirname, device=device,
                                   kv_cache_dtype=self._kv_dtype)


class DecodeSession:
    """One slot table: the per-lane KV cache plus occupancy bookkeeping
    (lengths, last tokens and the active mask, on the host).  NOT
    thread-safe — a serving lane owns its session exclusively."""

    def __init__(self, predictor, n_slots):
        self.predictor = predictor
        self.n_slots = int(n_slots)
        L, H, Dh, _ = predictor._dims()
        shape = (L, self.n_slots, predictor.max_seq_len, H, Dh)
        # an int8 slot table holds exact int8 zeros when free
        dtype = torch.int8 if predictor.kv_cache_dtype == "int8" \
            else torch.float32
        self._kc = torch.zeros(shape, dtype=dtype, device=predictor.device)
        self._vc = torch.zeros(shape, dtype=dtype, device=predictor.device)
        self.lengths = np.zeros(self.n_slots, np.int32)
        self.last_tokens = np.zeros(self.n_slots, np.int32)
        self.active = np.zeros(self.n_slots, bool)
        self.steps = 0
        self._windows = {}   # n_steps -> its captured CUDA graph

    # -- occupancy ------------------------------------------------------

    def free_slots(self):
        return [i for i in range(self.n_slots) if not self.active[i]]

    def occupancy(self):
        return int(self.active.sum())

    def cache_bytes(self):
        """Measured slot-table footprint: the K + V tensors' bytes, plus
        the int8 cache's fp32 scale table."""
        scales = self.predictor._kv_scales
        return sum(t.numel() * t.element_size()
                   for t in (self._kc, self._vc)) \
            + (0 if scales is None else int(scales.nbytes))

    def room(self, slot):
        """Generated tokens this slot can still hold."""
        return int(self.predictor.max_seq_len - self.lengths[slot])

    # -- phases ---------------------------------------------------------

    def prefill(self, slot, tokens):
        """Run the prompt through the bucketed prefill, land its K/V in
        `slot` (in place), and return the first generated token.  The
        slot must be free, and therefore zeroed."""
        if self.active[slot]:
            raise ValueError("slot %d is occupied" % slot)
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = tokens.size
        if n < 1:
            raise ValueError("empty prompt")
        self.predictor.check_tokens(tokens)
        bucket = self.predictor.prompt_bucket(n)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = tokens
        tok, kc, vc = self.predictor.prefill(padded, n)
        # positions past the bucket are already zero (free zeroed them)
        self._kc[:, slot, :bucket] = kc[:, 0]
        self._vc[:, slot, :bucket] = vc[:, 0]
        self.lengths[slot] = n
        self.last_tokens[slot] = tok
        self.active[slot] = True
        return tok

    def decode(self):
        """ONE step over the whole slot table; returns the np.int32
        [n_slots] token vector (meaningful for the slots active at call
        time) and bumps each active slot's length and last token."""
        N = self.n_slots
        act = self.active
        # one host->device copy carries the step's integer inputs
        ints = torch.from_numpy(np.concatenate(
            [self.lengths, self.last_tokens, act]).astype(np.int64)).to(
                self.predictor.device)
        toks = self.predictor.model.step(
            self._kc, self._vc, ints[:N], ints[N:2 * N], ints[2 * N:] != 0)
        toks = toks.cpu().numpy()
        self.lengths = self.lengths + act.astype(np.int32)
        self.last_tokens = np.where(act, toks, self.last_tokens).astype(
            np.int32)
        self.steps += 1
        return toks

    def _fused_inputs(self, n_steps, budget, max_trips):
        """(n_steps, the packed int32 window inputs) with paddle_tpu's
        clipping: budget to [0, n_steps] and 0 for inactive slots,
        max_trips to [1, n_steps]."""
        T = int(n_steps)
        if T < 1:
            raise ValueError("n_steps must be >= 1, got %d" % T)
        act = self.active
        if budget is None:
            b = np.where(act, T, 0)
        else:
            b = np.asarray(budget, np.int64).reshape(self.n_slots)
            b = np.clip(np.where(act, b, 0), 0, T)
        mt = T if max_trips is None else max(1, min(int(max_trips), T))
        return T, np.concatenate([self.lengths, self.last_tokens, act, b,
                                  [mt]]).astype(np.int32)

    def _fused_outputs(self, T, out):
        """Unpack a window's outputs into the session's bookkeeping;
        returns (tokens [N, T], counts [N], trips)."""
        N = self.n_slots
        toks = out[:N * T].reshape(N, T)
        counts = out[N * T:N * T + N]
        trips = int(out[N * T + N])
        self.lengths = out[N * T + N + 1:N * T + 2 * N + 1].copy()
        self.last_tokens = out[N * T + 2 * N + 1:].copy()
        self.steps += trips
        return toks, counts, trips

    def decode_fused(self, n_steps, budget=None, max_trips=None):
        """Up to `n_steps` decode steps in ONE dispatch (paddle_tpu's
        `decode_fused`).  Returns (tokens [n_slots, n_steps] int32,
        counts [n_slots] int32, trips int): slot s emitted `counts[s]`
        tokens, `tokens[s, :counts[s]]` in stream order; `trips` is the
        number of steps in which some slot still ran.  `budget`
        [n_slots] caps each slot's tokens (clipped to [0, n_steps], 0 for
        inactive slots); `max_trips` clamps the whole window (the serving
        deadline governor) to [1, n_steps] without a new capture.  A slot
        stops after EOS, at its budget, or with its cache full.

        On the card the window is one CUDA graph per n_steps, captured on
        first use over this session's caches and replayed; its trips
        after the last running slot stopped run fully masked.  On the CPU
        it is `decode_fused_plain`.  Either way the stream is bit-exact
        against n_steps `decode()` calls: every trip is the same masked
        step."""
        if self.predictor.device.type != "cuda":
            return self.decode_fused_plain(n_steps, budget, max_trips)
        T, ins = self._fused_inputs(n_steps, budget, max_trips)
        win = self._windows.get(T)
        if win is None:
            model, eos = self.predictor.model, self.predictor.eos_id
            win = self._windows[T] = _CapturedWindow(
                self.predictor.device, ins.size,
                lambda t: _fused_window(model, self._kc, self._vc, t, T,
                                        eos, early_exit=False))
        return self._fused_outputs(T, win.run(ins))

    def decode_fused_plain(self, n_steps, budget=None, max_trips=None):
        """The plain version of `decode_fused`: the same masked step in an
        eager loop that ends once no slot runs.  `decode_fused` runs it
        on the CPU; on the card it runs only when called by name."""
        T, ins = self._fused_inputs(n_steps, budget, max_trips)
        out = _fused_window(
            self.predictor.model, self._kc, self._vc,
            torch.from_numpy(ins).to(self.predictor.device), T,
            self.predictor.eos_id, early_exit=True)
        return self._fused_outputs(T, out.cpu().numpy())

    def graph_stats(self):
        """{n_steps: {"replays", "launches" per replay, "warmup"
        launches}} of this session's captured windows (none on the
        CPU)."""
        return {T: w.stats() for T, w in sorted(self._windows.items())}

    def verify(self, chunk):
        """One speculative verify step (`CausalLM.verify`) over the slot
        table: chunk [n_slots, C] int32 host tokens (the pending token,
        then the drafts); every active slot needs >= C rows of room.
        Returns (g [n_slots, C], m [n_slots]) np.int32 — meaningful for
        the active slots — and leaves the lengths and last tokens to the
        caller, with the caches holding the pending token's and the m
        accepted drafts' rows."""
        N = self.n_slots
        chunk = np.asarray(chunk, np.int32).reshape(N, -1)
        ints = torch.from_numpy(np.concatenate(
            [self.lengths, chunk.reshape(-1), self.active]).astype(
                np.int64)).to(self.predictor.device)
        g, m = self.predictor.model.verify(
            self._kc, self._vc, ints[:N], ints[N:N + chunk.size].reshape(
                chunk.shape), ints[N + chunk.size:] != 0)
        gm = torch.cat([g, m[:, None]], dim=1).cpu().numpy()
        return gm[:, :-1], gm[:, -1]

    def free(self, slot):
        """Release a slot: its K/V lines are ZEROED (in place) before it
        can be reused, so a later occupant never sees a previous
        request's keys."""
        self._kc[:, slot].zero_()
        self._vc[:, slot].zero_()
        self.lengths[slot] = 0
        self.last_tokens[slot] = 0
        self.active[slot] = False

    def rollback(self, slot, n, last_token=None):
        """Roll `slot` back by `n` cached positions: the length retreats
        and the rolled-back K/V rows are zeroed in place, so the slot is
        bit-identical to one that never advanced past the restored
        length.  `last_token`, when given, restores the pending token."""
        slot, n = int(slot), int(n)
        if n < 0:
            raise ValueError("rollback of %d positions" % n)
        length = int(self.lengths[slot])
        if n > length:
            raise ValueError(
                "rollback of %d positions on slot %d with only %d "
                "cached" % (n, slot, length))
        if n > 0:
            self._kc[:, slot, length - n:length].zero_()
            self._vc[:, slot, length - n:length].zero_()
            self.lengths[slot] = length - n
        if last_token is not None:
            self.last_tokens[slot] = np.int32(last_token)

    def slot_is_zero(self, slot):
        """True when the slot's K and V cache lines are exact zeros."""
        return not bool(self._kc[:, slot].any()) \
            and not bool(self._vc[:, slot].any())


class SpeculativeDecodeSession:
    """Draft-and-verify generation over one slot table: pairs the fp32
    *target* predictor with a cheap *draft* predictor (the int8 twin of
    the same artifact, or any decode artifact sharing its vocab and eos)
    and advances every occupied slot 1..k+1 committed tokens per round:

      1. DRAFT: k batched draft decode steps propose d1..dk per slot
         (the draft keeps its own slot table, mirroring the committed
         stream);
      2. VERIFY: the target scores all k+1 positions in one verify step
         (`DecodeSession.verify`), acceptance and stale-row zeroing
         included;
      3. COMMIT: the longest greedily-agreeing prefix plus the target's
         correction (or bonus) token commits to the target cache; the
         draft rolls its rejected rows back (`DecodeSession.rollback`),
         or runs one catch-up step after a fully accepted round, so both
         tables mirror the committed stream again.

    Every committed token is a target argmax, so the stream is
    bit-identical to target-only plain decode; the draft only changes
    how many steps that stream costs.  A draft failure
    (`set_draft_poison`, a raising draft) degrades the session to
    target-only plain rounds within the same round — `degraded` latches
    and `degrade_error` says why; the stream never stalls or corrupts.
    A kernel that fails to build or launch (`KernelError`) is no draft
    failure: it raises, on the draft side as on the target's.

    Duck-types the DecodeSession surface the DecodeBatcher drives
    (prefill/free/room/free_slots/occupancy/slot_is_zero/cache_bytes),
    with `step()`, the variable-accept round returning (tokens [N, k+1],
    counts [N]), in place of `decode()`.  A round is driven from the
    host, or fused into one dispatch (`step(fused=True)`).  NOT
    thread-safe: the same single-owner contract as DecodeSession."""

    def __init__(self, target, draft, n_slots, spec_k):
        if int(spec_k) < 1:
            raise ValueError("spec_k must be >= 1, got %r" % (spec_k,))
        if draft.vocab_size != target.vocab_size:
            raise ValueError(
                "draft vocab %d != target vocab %d — not a compatible "
                "draft artifact" % (draft.vocab_size, target.vocab_size))
        if draft.eos_id != target.eos_id:
            raise ValueError("draft eos_id %d != target eos_id %d"
                             % (draft.eos_id, target.eos_id))
        if draft.max_seq_len < target.max_seq_len:
            raise ValueError(
                "draft max_seq_len %d < target max_seq_len %d — the draft "
                "cache cannot mirror the committed stream"
                % (draft.max_seq_len, target.max_seq_len))
        self.predictor = target
        self.draft_predictor = draft
        self.spec_k = int(spec_k)
        self.n_slots = int(n_slots)
        self.session = target.new_session(n_slots)
        self.draft_session = draft.new_session(n_slots)
        self._degraded = False
        self.degrade_error = None
        self.rounds = 0          # verify steps
        self.plain_steps = 0     # fallback / degraded plain rounds
        self.proposed = 0        # draft tokens offered to verify
        self.accepted = 0        # draft tokens accepted
        self._window = None      # the fused round's CUDA graph
        self.last_spec = False   # did the latest round verify?
        self.last_draft_end = None   # monotonic draft -> verify boundary

    # -- DecodeSession surface (the batcher's contract) -----------------

    @property
    def steps(self):
        return self.session.steps

    @property
    def degraded(self):
        return self._degraded

    def free_slots(self):
        return self.session.free_slots()

    def occupancy(self):
        return self.session.occupancy()

    def room(self, slot):
        return self.session.room(slot)

    def slot_is_zero(self, slot):
        return self.session.slot_is_zero(slot)

    def cache_bytes(self):
        """The target table's bytes: the one the committed stream lives
        in."""
        return self.session.cache_bytes()

    def _degrade(self, exc):
        self._degraded = True
        if self.degrade_error is None:
            self.degrade_error = "%s: %s" % (type(exc).__name__, exc)

    def prefill(self, slot, tokens):
        """Prefill both tables; the draft's own first token is discarded
        and its pending token pinned to the target's (the committed
        stream is always the target's)."""
        first = self.session.prefill(slot, tokens)
        if not self._degraded:
            try:
                _check_draft_poison()
                self.draft_session.prefill(slot, tokens)
                self.draft_session.last_tokens[slot] = np.int32(first)
            except KernelError:
                raise
            except Exception as e:
                self._degrade(e)
        return first

    def free(self, slot):
        self.session.free(slot)
        if self.draft_session.active[slot]:
            self.draft_session.free(slot)

    # -- the speculative round ------------------------------------------

    def _draft_catchup(self, mask, pins, draft_delay=0.0):
        """Advance the draft one step for the `mask` slots (consuming
        their pending token, landing its K/V row) and re-pin their
        pending tokens to the committed stream's (`pins` [N])."""
        ds = self.draft_session
        saved = ds.active
        try:
            _check_draft_poison()
            if draft_delay:
                time.sleep(draft_delay)
            ds.active = mask
            ds.decode()
        except KernelError:
            raise
        except Exception as e:
            self._degrade(e)
            return
        finally:
            ds.active = saved
        for s in np.nonzero(mask)[0]:
            ds.last_tokens[s] = np.int32(pins[s])

    def step(self, fused=False, step_delay=0.0, draft_delay=0.0):
        """One round over the slot table.  Returns (tokens [N, k+1]
        int32, counts [N] int32): slot s committed `counts[s]` tokens
        this round, `tokens[s, :counts[s]]` in stream order (0 for
        inactive slots, 1 in a plain round, 1..k+1 in a speculative one).

        A round runs speculatively unless the session is degraded or
        some occupied slot lacks the k+1 cache rows a verify writes:
        those rounds run ONE plain target step for every slot (a nearly
        full slot never blocks progress), with a draft catch-up step
        keeping the tables mirrored.

        `fused=True` runs a speculative round as ONE dispatch
        (paddle_tpu's fused round): on the card one CUDA graph per
        session, captured on first use, holds the k draft steps, the
        verify, the commit, the draft rollback and the catch-up
        (`_spec_window`); on the CPU the same math runs eagerly.  The
        committed stream is bit-identical either way.  The draft-poison
        chaos check still fires k times, on the host before the
        dispatch, so a poisoned draft degrades the round to the plain
        round as in the host-driven one.

        `step_delay` / `draft_delay` are the serving batcher's stand-ins
        for device cost (`serving.batcher.set_dispatch_delay` /
        `set_draft_delay`): sleeps before the verify (or plain) step and
        before each draft step.  `last_spec` says whether the round
        verified, and `last_draft_end` is its draft -> verify instant."""
        return self._round(fused, graph=True, step_delay=step_delay,
                           draft_delay=draft_delay)

    def step_fused_plain(self):
        """`step(fused=True)` with the fused round's math run eagerly:
        its plain version, which `step(fused=True)` runs on the CPU and
        the card runs only when called by name."""
        return self._round(True, graph=False)

    def graph_stats(self):
        """{"replays", "launches" per replay, "warmup" launches} of the
        captured speculative round; None before the first fused round on
        the card."""
        return None if self._window is None else self._window.stats()

    def _fused_round(self, active, occupied, graph):
        """The speculative round in one dispatch (`_spec_window`), and
        its host bookkeeping as paddle_tpu's fused branch keeps it."""
        ts, ds = self.session, self.draft_session
        k, N = self.spec_k, self.n_slots
        C = k + 1
        ins = np.concatenate([ts.lengths, ts.last_tokens, ds.lengths,
                              ds.last_tokens, active]).astype(np.int32)
        dev = self.predictor.device

        def body(t):
            return _spec_window(self.predictor.model,
                                self.draft_predictor.model, ts._kc, ts._vc,
                                ds._kc, ds._vc, t, k)
        if graph and dev.type == "cuda":
            if self._window is None:
                self._window = _CapturedWindow(dev, ins.size, body)
            out = self._window.run(ins)
        else:
            out = body(torch.from_numpy(ins).to(dev)).cpu().numpy()
        g = out[:N * C].reshape(N, C)
        m = np.where(active, out[N * C:N * C + N], 0).astype(np.int32)
        ts.lengths, ts.last_tokens, ds.lengths, ds.last_tokens = (
            out[N * C + N * i:N * C + N * (i + 1)].copy()
            for i in range(1, 5))
        ts.steps += 1
        # the draft table ran k steps, and the catch-up when a slot
        # accepted every draft (paddle_tpu's count)
        ds.steps += k + int(bool((m[occupied] == k).any()))
        self.rounds += 1
        self.proposed += k * occupied.size
        self.accepted += int(m[occupied].sum())
        return g, np.where(active, m + 1, 0).astype(np.int32)

    def _round(self, fused, graph, step_delay=0.0, draft_delay=0.0):
        ts = self.session
        k = self.spec_k
        C = k + 1
        N = self.n_slots
        active = ts.active.copy()
        occupied = np.nonzero(active)[0]
        spec_ok = (not self._degraded and occupied.size > 0
                   and all(ts.room(int(s)) >= C for s in occupied))
        self.last_spec = False
        if spec_ok and fused:
            # the poison counter advances once per logical draft step,
            # before the dispatch: a poisoned draft degrades this round
            # to the plain round before the fused round launches
            try:
                for _ in range(k):
                    _check_draft_poison()
                    if draft_delay:
                        time.sleep(draft_delay)
            except KernelError:
                raise
            except Exception as e:
                self._degrade(e)
                spec_ok = False
            if spec_ok:
                self.last_draft_end = time.monotonic()
                if step_delay:
                    time.sleep(step_delay)
                out = self._fused_round(active, occupied, graph)
                self.last_spec = True
                return out
        drafts = []
        if spec_ok:
            try:
                for _ in range(k):
                    _check_draft_poison()
                    if draft_delay:
                        time.sleep(draft_delay)
                    drafts.append(self.draft_session.decode())
            except KernelError:
                raise
            except Exception as e:
                # the draft died mid-round: drop its proposals and keep
                # the stream moving with a plain target step this round
                self._degrade(e)
                spec_ok = False
        if spec_ok:
            self.last_draft_end = time.monotonic()
            if step_delay:
                time.sleep(step_delay)
            chunk = np.zeros((N, C), np.int32)
            chunk[:, 0] = ts.last_tokens
            for j, d in enumerate(drafts):
                chunk[:, j + 1] = d
            g, m = ts.verify(chunk)
            m = np.where(active, m, 0).astype(np.int32)
            counts = np.where(active, m + 1, 0).astype(np.int32)
            ts.lengths = (ts.lengths + counts).astype(np.int32)
            ts.last_tokens = np.where(
                active, g[np.arange(N), np.minimum(m, k)],
                ts.last_tokens).astype(np.int32)
            ts.steps += 1
            # draft sync: rejected rows roll back; fully accepted slots
            # owe the draft one catch-up row (it proposed d_k without
            # consuming it)
            for s in occupied:
                s = int(s)
                if m[s] < k:
                    self.draft_session.rollback(
                        s, k - 1 - int(m[s]), last_token=int(g[s, m[s]]))
            full = active & (m == k)
            if full.any():
                self._draft_catchup(full, g[:, k], draft_delay=draft_delay)
            self.rounds += 1
            self.proposed += k * occupied.size
            self.accepted += int(m[occupied].sum())
            self.last_spec = True
            return g, counts
        # the plain round: one target step, every occupied slot advances
        # exactly one token (the degraded session lives here)
        if step_delay:
            time.sleep(step_delay)
        toks = ts.decode()
        self.plain_steps += 1
        if not self._degraded and active.any():
            self._draft_catchup(active, toks, draft_delay=draft_delay)
        out = np.zeros((N, C), np.int32)
        out[:, 0] = toks
        return out, active.astype(np.int32)


def load_decode_predictor(dirname, kv_cache_dtype=None, device=None):
    """Open a `save_decode_model` artifact on `device` (default cuda)."""
    return GenerativePredictor(dirname, device=device,
                               kv_cache_dtype=kv_cache_dtype)


def greedy_decode(predictor, tokens, max_new_tokens, n_slots=1,
                  slot=0, session=None):
    """Single-request reference decode: prefill + step loop on a
    dedicated session — the unbatched oracle that batched streams are
    held against.  Returns (generated_tokens, finish_reason)."""
    sess = session if session is not None \
        else predictor.new_session(n_slots)
    out = []
    reason = "length"
    tok = sess.prefill(slot, tokens)
    out.append(tok)
    eos = predictor.eos_id
    try:
        while len(out) < max_new_tokens and out[-1] != eos:
            if sess.room(slot) <= 0:
                break
            toks = sess.decode()
            out.append(int(toks[slot]))
    finally:
        sess.free(slot)
    if out[-1] == eos:
        reason = "eos"
    return out, reason
