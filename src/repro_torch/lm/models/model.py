"""Model assembly: every assigned architecture as a sequence of
homogeneous *stages*.

Stage kinds:
  attn_dense   — pre-norm GQA attention + dense MLP (all dense archs)
  attn_moe     — attention + MoE FFN (granite, deepseek)
  jamba_period — Jamba period of `hybrid.period` sublayers: Mamba
                 everywhere except attention at `hybrid.attn_index`;
                 MoE FFN every other sublayer
  xlstm_pair   — mLSTM block + sLSTM block (no FFN; d_ff = 0)
  enc_layer    — bidirectional encoder layer (whisper)
  dec_layer    — causal self-attn + cross-attn + MLP (whisper decoder)

Within a stage, per-layer parameters are stacked on a leading ``layers``
axis (the reference's layout, so its parameters load as they are) and a
loop runs the layers one after the other.  In train mode each stacked
leaf is unbound once a stage (its backward stacks one gradient, where
slicing a layer at a time would add a full-size zero gradient a layer)
and, with ``cfg.remat``, each layer runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable``: only a layer's input is kept).

``Model`` is an ``nn.Module``: construction allocates every parameter
(uninitialized) on the model's device, ``init`` draws them from an
explicit ``torch.Generator`` and ``load_state_dict`` takes weights from
elsewhere (``interop.lm_params_from_numpy``).  ``param_axes`` maps each
parameter's name to its logical sharding axes.  Serving modes keep the
reference's call forms: ``prefill(params, batch, caches)`` and
``decode_step(params, tokens_t, caches, index)`` with ``params =
model.param_tree()``.  Caches are allocated by ``init_cache`` and updated
in place (the returned caches hold the same tensors); ``decode_step``
also takes a (B,) tensor of per-sequence positions, each sequence
writing and masking at its own index.  ``loss(params, batch)`` is the
training mode; its gradients are the parameters' ``.grad`` after
``backward`` (``lm.train.make_train_step`` turns them on).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.engine import resolve_device
from repro_torch.lm.configs.base import ModelConfig
from repro_torch.lm.models import layers as L
from repro_torch.lm.models import moe as M
from repro_torch.lm.models import ssm as S
from repro_torch.sharding.specs import (ShardCtx, constrain, constrain_like,
                                       gathered, is_dtensor, local_call,
                                       local_part, place, sharding_for, spmd)


def _dt(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


@dataclasses.dataclass(frozen=True)
class Stage:
    kind: str
    count: int
    d_ff: int = 0          # dense-FFN override (deepseek first layer)
    use_moe: bool = False


def build_stages(cfg: ModelConfig) -> list[Stage]:
    if cfg.family in ("dense", "vlm"):
        return [Stage("attn_dense", cfg.n_layers)]
    if cfg.family == "moe":
        st = []
        fd = cfg.moe.first_dense_layers
        if fd:
            st.append(Stage("attn_dense", fd, d_ff=cfg.moe.first_dense_d_ff))
        st.append(Stage("attn_moe", cfg.n_layers - fd, use_moe=True))
        return st
    if cfg.family == "hybrid":
        per = cfg.hybrid.period
        if cfg.n_layers % per:
            raise ValueError(f"{cfg.n_layers} layers in periods of {per}")
        return [Stage("jamba_period", cfg.n_layers // per, use_moe=True)]
    if cfg.family == "ssm":
        if cfg.n_layers % 2:
            raise ValueError(f"{cfg.n_layers} layers in mLSTM/sLSTM pairs")
        return [Stage("xlstm_pair", cfg.n_layers // 2)]
    if cfg.family == "enc_dec":
        return [Stage("enc_layer", cfg.encoder.n_layers),
                Stage("dec_layer", cfg.n_layers)]
    raise ValueError(cfg.family)


def _token_ce(logits, targets):
    """(B, S) cross entropy of float32 (B, S, V) logits at int targets."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets[..., None])[..., 0]
    return lse - ll


def _local_ce(ctx):
    """``_token_ce`` on a mesh: ``gather`` along a sharded vocab has no
    ``DTensor`` rule, so each rank takes its batch rows with the whole
    vocab."""
    return local_call(_token_ce, ctx, (("act_batch", None, None),
                                       ("act_batch", None)),
                      ("act_batch", None))


def _write_back(dst, src):
    """A layer's new cache leaf into its slot (a placed slot takes the
    new value in its own placements)."""
    if dst is src:
        return
    if is_dtensor(dst):
        src = constrain_like(src, dst)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


def _plain(t):
    """A ``DTensor`` result as the plain tensor every rank holds."""
    return t.full_tensor() if is_dtensor(t) else t


# ---- trees of tensors -----------------------------------------------------

def _map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _stack_leaves(per_layer):
    """Leaf trees of each layer -> one tree, each leaf stacked on a
    leading ``layers`` axis."""
    if isinstance(per_layer[0], dict):
        return {k: _stack_leaves([t[k] for t in per_layer])
                for k in per_layer[0]}
    return L.Leaf(torch.stack([l.value for l in per_layer]),
                  ("layers",) + per_layer[0].axes)


class _Params(nn.Module):
    """A node of the parameter tree: leaves are parameters, dicts are
    child nodes, so ``state_dict`` names are the tree's dotted paths."""

    def __init__(self, tree: dict):
        super().__init__()
        _register(self, tree)


def _register(module: nn.Module, tree: dict):
    for k, v in tree.items():
        if isinstance(v, dict):
            module.add_module(k, _Params(v))
        else:
            module.register_parameter(k, nn.Parameter(v, requires_grad=False))


def _tree_of(module: nn.Module) -> dict:
    out = dict(module._parameters)
    out.update({k: _tree_of(m) for k, m in module._modules.items()})
    return out


class Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None,
                 ctx: ShardCtx | None = None):
        super().__init__()
        self.cfg = cfg
        self.stages = build_stages(cfg)
        self.pdt = _dt(cfg.param_dtype)
        self.adt = _dt(cfg.dtype)
        self.device = resolve_device(device)
        shapes, axes = L.split_tree(self._tree(L.Draw(None)))
        self.param_axes: dict[str, tuple] = _flatten(axes)
        self._axes_tree = axes
        if ctx is not None and ctx.mesh is not None:
            from torch.distributed.tensor import empty as dt_empty

            def alloc(m, a):
                mesh, pl = sharding_for(a, ctx, m.shape)
                return dt_empty(m.shape, dtype=m.dtype, device_mesh=mesh,
                                placements=pl)
            _register(self, _map(alloc, shapes, axes))
        else:
            _register(self, _map(lambda m: torch.empty(
                m.shape, dtype=m.dtype, device=self.device), shapes))

    @torch.no_grad()
    def place(self, ctx: ShardCtx):
        """Put the parameters on ``ctx``'s mesh, each as a ``DTensor``
        placed by its logical axes (one leaf at a time); returns the
        model."""
        _register(self, place(_map(lambda t: t.detach(), self.param_tree()),
                              self._axes_tree, ctx))
        return self

    @property
    def sharded(self) -> bool:
        return any(is_dtensor(p) for p in self.parameters())

    def param_tree(self) -> dict:
        """The parameters as the reference's nested params dict."""
        return _tree_of(self)

    # ------------------------------------------------------------------ init
    def _init_layer(self, key, stage: Stage):
        cfg = self.cfg
        norm = lambda: L.ones_init(key, (cfg.d_model,), ("embed",), self.pdt)
        if stage.kind in ("attn_dense", "attn_moe", "enc_layer"):
            p = {"ln1": norm(), "attn": L.init_attention(key, cfg, self.pdt),
                 "ln2": norm()}
            if stage.use_moe:
                p["moe"] = M.init_moe(key, cfg, self.pdt)
            else:
                p["mlp"] = L.init_mlp(key, cfg, self.pdt,
                                      d_ff=stage.d_ff or None)
            return p
        if stage.kind == "dec_layer":
            return {
                "ln1": norm(), "self_attn": L.init_attention(key, cfg, self.pdt),
                "ln2": norm(), "cross_attn": L.init_attention(key, cfg, self.pdt),
                "ln3": norm(), "mlp": L.init_mlp(key, cfg, self.pdt),
            }
        if stage.kind == "jamba_period":
            subs = {}
            hy = cfg.hybrid
            for i in range(hy.period):
                sub = {"ln1": norm()}
                if i == hy.attn_index:
                    sub["attn"] = L.init_attention(key, cfg, self.pdt)
                else:
                    sub["mamba"] = S.init_mamba(key, cfg, self.pdt)
                sub["ln2"] = norm()
                if i % 2 == 1 and cfg.moe is not None:
                    sub["moe"] = M.init_moe(key, cfg, self.pdt)
                else:
                    sub["mlp"] = L.init_mlp(key, cfg, self.pdt)
                subs[f"sub{i}"] = sub
            return subs
        if stage.kind == "xlstm_pair":
            return {
                "ln_m": norm(), "mlstm": S.init_mlstm(key, cfg, self.pdt),
                "ln_s": norm(), "slstm": S.init_slstm(key, cfg, self.pdt),
            }
        raise ValueError(stage.kind)

    def _top(self, key):
        cfg = self.cfg
        return {"embed": L.init_embedding(key, cfg, self.pdt),
                "unembed": L.init_unembed(key, cfg, self.pdt),
                "ln_f": L.ones_init(key, (cfg.d_model,), ("embed",), self.pdt)}

    def _tree(self, key):
        """The whole Leaf tree, each stage stacked (meta: shapes only)."""
        tree = self._top(key)
        for si, stage in enumerate(self.stages):
            tree[f"stage{si}"] = _stack_leaves(
                [self._init_layer(key, stage) for _ in range(stage.count)])
        return tree

    @torch.no_grad()
    def init(self, generator: torch.Generator | None = None):
        """Draws every parameter from ``generator`` (default: seed 0 on the
        model's device) with ``dense_init``'s distributions, in float32
        and then cast to ``param_dtype``, one layer at a time into its
        slot of the stacked parameters.  Returns (params, logical_axes)
        trees."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        key = L.Draw(generator)
        params = self.param_tree()

        def put(dst, value, i=None):
            # a placed parameter takes the rank's part of the drawn value
            if is_dtensor(dst):
                dst, value = dst.to_local(), local_part(
                    value, dst, 0 if i is None else 1)
            (dst if i is None else dst[i]).copy_(value)

        _map(lambda dst, leaf: put(dst, leaf.value),
             {k: params[k] for k in ("embed", "unembed", "ln_f")},
             self._top(key))
        for si, stage in enumerate(self.stages):
            for i in range(stage.count):
                _map(lambda dst, leaf: put(dst, leaf.value, i),
                     params[f"stage{si}"], self._init_layer(key, stage))
        return params, self._axes_tree

    # -------------------------------------------------------------- sublayers
    def _attn_block(self, p, x, positions, mask_fn, ctx, cache, cache_index,
                    names=("ln1", "attn")):
        cfg = self.cfg
        h = L.rms_norm(x, p[names[0]], cfg.norm_eps)
        out, new_cache = L.apply_attention(
            p[names[1]], cfg, h, positions, mask_fn, ctx,
            cache=cache, cache_index=cache_index)
        return x + out, new_cache

    def _ffn_block(self, p, x, ctx, moe_groups=None):
        cfg = self.cfg
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if "moe" in p:
            if moe_groups:
                out, aux = M.apply_moe_grouped(p["moe"], cfg, h, ctx,
                                               groups=moe_groups)
            else:
                out, aux = M.apply_moe(p["moe"], cfg, h, ctx)
        else:
            out, aux = L.apply_mlp(p["mlp"], cfg, h, ctx), {}
        return x + out, aux

    def _apply_layer(self, stage: Stage, p, x, positions, mask_fn, ctx,
                     cache, cache_index, mode, enc_out=None, enc_pos=None,
                     moe_groups=None):
        """One layer. Returns (x, new_cache, aux)."""
        cfg = self.cfg
        aux = {}
        if stage.kind in ("attn_dense", "attn_moe", "enc_layer"):
            mfn = L.full_mask if stage.kind == "enc_layer" else mask_fn
            x, new_cache = self._attn_block(
                p, x, positions, mfn, ctx, cache, cache_index)
            x, aux = self._ffn_block(p, x, ctx, moe_groups)
            return x, new_cache, aux
        if stage.kind == "dec_layer":
            x, new_self = self._attn_block(
                p, x, positions, mask_fn, ctx,
                cache.get("self") if cache else None, cache_index,
                names=("ln1", "self_attn"))
            h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
            co, _ = L.apply_attention(
                p["cross_attn"], cfg, h, positions, L.full_mask, ctx,
                kv_override=(enc_out, enc_pos))
            x = x + co
            h = L.rms_norm(x, p["ln3"], cfg.norm_eps)
            x = x + L.apply_mlp(p["mlp"], cfg, h, ctx)
            return x, ({"self": new_self} if new_self else None), aux
        if stage.kind == "jamba_period":
            hy = cfg.hybrid
            new_cache = {}
            for i in range(hy.period):
                sp = p[f"sub{i}"]
                sub_cache = cache.get(f"sub{i}") if cache else None
                if i == hy.attn_index:
                    x, nc = self._attn_block(
                        sp, x, positions, mask_fn, ctx, sub_cache, cache_index)
                else:
                    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
                    if mode == "decode":
                        out, nc = S.mamba_step(sp["mamba"], cfg, h, sub_cache, ctx)
                    else:
                        out, nc = S.apply_mamba(sp["mamba"], cfg, h, ctx)
                    x = x + out
                x, a = self._ffn_block(sp, x, ctx, moe_groups)
                for k, v in a.items():
                    aux[k] = aux.get(k, 0.0) + v
                if nc is not None:
                    new_cache[f"sub{i}"] = nc
            return x, (new_cache or None), aux
        if stage.kind == "xlstm_pair":
            h = L.rms_norm(x, p["ln_m"], cfg.norm_eps)
            if mode == "decode":
                out, ncm = S.mlstm_step(p["mlstm"], cfg, h,
                                        cache["m"] if cache else None, ctx)
            else:
                out, ncm = S.apply_mlstm(p["mlstm"], cfg, h, ctx)
            x = x + out
            h = L.rms_norm(x, p["ln_s"], cfg.norm_eps)
            if mode == "decode":
                out, ncs = S.slstm_step(p["slstm"], cfg, h,
                                        cache["s"] if cache else None, ctx)
            else:
                out, ncs = S.apply_slstm(p["slstm"], cfg, h, ctx)
            x = x + out
            return x, {"m": ncm, "s": ncs}, aux
        raise ValueError(stage.kind)

    # ---------------------------------------------------------------- stages
    def _run_stage(self, si, stage, params, x, positions, mask_fn, ctx,
                   caches, cache_index, mode, enc_out=None, enc_pos=None,
                   moe_groups=None):
        """Run the stacked layers of one stage in order.  A layer's new
        cache is written into its slot of the stage's stacked cache."""
        p_st = params[f"stage{si}"]
        cache_st = caches.get(f"stage{si}") if caches else None
        if mode == "train":
            p_st = _map(lambda t: t.unbind(0), p_st)
        aux = {}
        for i in range(stage.count):
            p_layer = _map(lambda t: t[i], p_st)
            cache_layer = (_map(lambda t: t[i], cache_st)
                           if cache_st is not None else None)
            x = constrain(x, ("act_batch", "act_seq", None), ctx)
            layer = lambda x, p=p_layer, c=cache_layer: self._apply_layer(
                stage, p, x, positions, mask_fn, ctx, c, cache_index, mode,
                enc_out, enc_pos, moe_groups)
            if mode == "train" and self.cfg.remat:
                x, new_cache, a = checkpoint(layer, x, use_reentrant=False,
                                             preserve_rng_state=False)
            else:
                x, new_cache, a = layer(x)
            if cache_layer is not None and new_cache is not None:
                _map(_write_back, {k: cache_layer[k] for k in new_cache},
                     new_cache)
            for k, v in a.items():
                aux[k] = aux.get(k, 0.0) + v
        return x, cache_st, aux

    # ---------------------------------------------------------------- fronts
    def _tokens(self, tokens):
        """Token ids as a plain tensor, whole on every rank: a placed
        batch is gathered first (the lookups index with them; a
        ``DTensor`` index is left to no sharding rule)."""
        return torch.as_tensor(gathered(tokens), device=self.device).long()

    def _embed_tokens(self, params, batch, ctx, pos_offset=0):
        cfg = self.cfg
        x = L.embed(params["embed"], self._tokens(batch["tokens"]),
                    cfg).to(self.adt)
        if cfg.pos == "sinusoidal":  # whisper decoder-style table positions
            n = x.shape[1]
            table = L.sinusoidal_positions(pos_offset + n, cfg.d_model,
                                           self.adt, self.device)
            x = x + table[None, pos_offset:pos_offset + n]
        prefix_len = 0
        if cfg.family == "vlm":
            patches = torch.as_tensor(batch["patch_embeds"],
                                      device=self.device).to(self.adt)
            x = torch.cat([patches, x], dim=1)
            prefix_len = patches.shape[1]
        x = constrain(x, ("act_batch", "act_seq", None), ctx)
        return x, prefix_len

    def _encoder(self, params, batch, ctx):
        """Whisper encoder over stub frame embeddings."""
        cfg = self.cfg
        frames = torch.as_tensor(batch["frames"], device=self.device
                                 ).to(self.adt)
        n = frames.shape[1]
        x = frames + L.sinusoidal_positions(n, cfg.d_model, self.adt,
                                            self.device)[None]
        positions = torch.arange(n, device=self.device)
        x, _, _ = self._run_stage(0, self.stages[0], params, x, positions,
                                  L.full_mask, ctx, None, None, "train")
        x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
        return x, positions

    # ----------------------------------------------------------------- modes
    def _backbone(self, params, x, positions, mask_fn, ctx, caches,
                  cache_index, mode, enc_out=None, enc_pos=None,
                  moe_groups=None):
        new_caches = {}
        aux = {}
        for si, stage in enumerate(self.stages):
            if stage.kind == "enc_layer":
                continue  # encoder handled separately
            x, nc, a = self._run_stage(
                si, stage, params, x, positions, mask_fn, ctx, caches,
                cache_index, mode, enc_out, enc_pos, moe_groups)
            if nc is not None:
                new_caches[f"stage{si}"] = nc
            for k, v in a.items():
                aux[k] = aux.get(k, 0.0) + v
        return x, new_caches, aux

    # ---- training -----------------------------------------------------------
    def loss(self, params, batch, ctx: ShardCtx | None = None):
        """Next-token CE (+ MoE aux). batch: tokens (B,S) [, labels (B,S),
        patch_embeds, frames]. Returns (total, metrics), 0-d float32
        tensors on the model's device.  On a bound mesh the parameters
        are ``DTensor``s, the activations are placed where the reference
        constrains them, and the results are plain tensors, the same on
        every rank."""
        with spmd(ctx):
            total, metrics = self._loss(params, batch, ctx)
            return _plain(total), {k: _plain(v) for k, v in metrics.items()}

    def _loss(self, params, batch, ctx):
        cfg = self.cfg
        labels = constrain(self._tokens(batch.get("labels", batch["tokens"])),
                           ("act_batch", None), ctx)
        enc_out = enc_pos = None
        if cfg.family == "enc_dec":
            enc_out, enc_pos = self._encoder(params, batch, ctx)
        x, prefix_len = self._embed_tokens(params, batch, ctx)
        positions = torch.arange(x.shape[1], device=self.device)
        mask_fn = (L.prefix_lm_mask(prefix_len) if prefix_len
                   else L.causal_mask)
        x, _, aux = self._backbone(params, x, positions, mask_fn, ctx,
                                   None, None, "train", enc_out, enc_pos)
        x = L.rms_norm(constrain(x, ("act_batch", None, None), ctx),
                       params["ln_f"], cfg.norm_eps)
        if prefix_len:
            x = x[:, prefix_len:]
        if "chunked_ce" in cfg.opts:
            ce = self._chunked_ce(params, x[:, :-1], labels[:, 1:], ctx)
        else:
            logits = L.unembed(params["unembed"], params["embed"], x, cfg,
                               ctx)
            lg = logits[:, :-1].float()
            ce = _local_ce(ctx)(lg, labels[:, 1:]).mean()
        total = ce
        metrics = {"ce": ce}
        for k, v in aux.items():
            metrics[k] = v
            if k in ("moe_load_balance", "moe_router_z"):
                total = total + v
        metrics["loss"] = total
        return total, metrics

    def _chunked_ce(self, params, x, labels, ctx, chunk: int = 256):
        """CE over sequence chunks, each chunk's logits recomputed in the
        backward (``torch.utils.checkpoint``): the (B, S, V) logits never
        exist at once (the peak is one chunk's (B, chunk, V)).  The same
        loss as the dense path."""
        cfg = self.cfg
        B, n, _ = x.shape
        nc = n // chunk if n % chunk == 0 else 1
        ck = n // nc

        def body(xb, tb):
            logits = L.unembed(params["unembed"], params["embed"], xb,
                               cfg, ctx).float()
            return _local_ce(ctx)(logits, tb).sum()

        total = torch.zeros((), dtype=torch.float32, device=self.device)
        for c in range(nc):
            sl = slice(c * ck, (c + 1) * ck)
            total = total + checkpoint(body, x[:, sl], labels[:, sl],
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        return total / (B * n)

    # ---- serving ----------------------------------------------------------
    def init_cache(self, batch_size: int, max_len: int,
                   cache_dtype=None, enc_frames: int | None = None):
        """Zeroed cache tree on the model's device, each stage's leaves
        stacked on a leading ``layers`` axis."""
        cfg = self.cfg
        cdt = cache_dtype or self.adt
        KV, hd = cfg.n_kv_heads, cfg.hd
        f32 = torch.float32

        def z(shape, dt, fill=0.0):
            return torch.full(shape, fill, dtype=dt, device=self.device)

        def attn_cache(n):
            return {"k": z((n, batch_size, max_len, KV, hd), cdt),
                    "v": z((n, batch_size, max_len, KV, hd), cdt)}

        caches = {}
        for si, stage in enumerate(self.stages):
            n = stage.count
            if stage.kind in ("attn_dense", "attn_moe"):
                caches[f"stage{si}"] = attn_cache(n)
            elif stage.kind == "dec_layer":
                caches[f"stage{si}"] = {"self": attn_cache(n)}
            elif stage.kind == "jamba_period":
                hy = cfg.hybrid
                per = {}
                di = cfg.mamba.expand * cfg.d_model
                for i in range(hy.period):
                    if i == hy.attn_index:
                        per[f"sub{i}"] = attn_cache(n)
                    else:
                        per[f"sub{i}"] = {
                            "conv": z((n, batch_size, cfg.mamba.d_conv - 1,
                                       di), cdt),
                            "ssm": z((n, batch_size, di, cfg.mamba.d_state),
                                     f32)}
                caches[f"stage{si}"] = per
            elif stage.kind == "xlstm_pair":
                H = cfg.n_heads
                caches[f"stage{si}"] = {
                    "m": {"C": z((n, batch_size, H, hd, hd), f32),
                          "n": z((n, batch_size, H, hd), f32),
                          "m": z((n, batch_size, H), f32)},
                    "s": {"c": z((n, batch_size, H, hd), f32),
                          "n": z((n, batch_size, H, hd), f32),
                          "m": z((n, batch_size, H), f32, -30.0)},
                }
        return caches

    @torch.no_grad()
    def prefill(self, params, batch, caches, ctx: ShardCtx | None = None):
        """Fill caches from a prompt; returns (last-token logits, caches).
        For enc_dec, also computes encoder output (stored under 'enc')."""
        with spmd(ctx):
            logits, caches = self._prefill(params, batch, caches, ctx)
            return _plain(logits), caches

    def _prefill(self, params, batch, caches, ctx):
        cfg = self.cfg
        enc_out = enc_pos = None
        if cfg.family == "enc_dec":
            enc_out, enc_pos = self._encoder(params, batch, ctx)
        x, prefix_len = self._embed_tokens(params, batch, ctx)
        positions = torch.arange(x.shape[1], device=self.device)
        mask_fn = (L.prefix_lm_mask(prefix_len) if prefix_len
                   else L.causal_mask)
        x, new_caches, _ = self._backbone(
            params, x, positions, mask_fn, ctx, caches, 0, "prefill",
            enc_out, enc_pos)
        x = L.rms_norm(constrain(x, ("act_batch", None, None), ctx),
                       params["ln_f"], cfg.norm_eps)
        logits = L.unembed(params["unembed"], params["embed"],
                           x[:, -1:], cfg, ctx)
        if cfg.family == "enc_dec":
            new_caches["enc"] = {"out": enc_out, "pos": enc_pos}
        return logits, new_caches

    @torch.no_grad()
    def decode_step(self, params, tokens_t, caches, index,
                    ctx: ShardCtx | None = None):
        """tokens_t: (B,1) next-token ids; index: the current length, an
        int (or 0-d tensor) shared by every sequence, or a (B,) tensor of
        per-sequence positions.  A per-sequence step also routes each
        sequence's MoE tokens as their own group, as a decode of one
        sequence at a time does."""
        with spmd(ctx):
            logits, caches = self._decode_step(params, tokens_t, caches,
                                               index, ctx)
            return _plain(logits), caches

    def _decode_step(self, params, tokens_t, caches, index, ctx):
        cfg = self.cfg
        tokens_t = self._tokens(tokens_t)
        x = L.embed(params["embed"], tokens_t, cfg).to(self.adt)
        per_seq = torch.is_tensor(index) and index.dim() == 1
        if per_seq:
            index = index.to(self.device).long()
            positions = index[:, None]
        else:
            index = int(index)
            positions = torch.tensor([index], device=self.device)
        enc_out = enc_pos = None
        if cfg.family == "enc_dec":
            enc_out = caches["enc"]["out"]
            enc_pos = caches["enc"]["pos"]
        if cfg.pos == "sinusoidal":
            smax = next(t for k, v in caches.items() if k != "enc"
                        for t in _flatten(v).values()).shape[2]
            table = L.sinusoidal_positions(smax, cfg.d_model, self.adt,
                                           self.device)
            if per_seq:
                x = x + table[index.clamp(0, smax - 1)][:, None]
            else:
                i = min(max(index, 0), smax - 1)
                x = x + table[i:i + 1][None]
        x, new_caches, _ = self._backbone(
            params, x, positions, L.causal_mask, ctx, caches, index,
            "decode", enc_out, enc_pos,
            moe_groups=x.shape[0] if per_seq else None)
        x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
        logits = L.unembed(params["unembed"], params["embed"], x, cfg, ctx)
        if cfg.family == "enc_dec":
            new_caches["enc"] = caches["enc"]
        return logits, new_caches
