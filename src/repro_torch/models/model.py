"""Model assembly for every family (dense, moe, ssm, hybrid, encdec, vlm);
PyTorch port of ``repro.models.model``.

The JAX package scans one period of the layer pattern over stacked
parameters, with ``cfg.first_k_dense`` head layers before it (kimi-k2's
dense first layer) and the pattern's leftover layers after it; here the
layers are an ``nn.ModuleList`` in absolute layer order (layer i has kind
``Model.kinds[i]``: the head layers' ``attn``, then the pattern tiled),
run by a Python loop.  ``convert.params_from_numpy`` maps the JAX tree
onto that order.

Blocks by family: dense, attention (``attn``/``local``) and an MLP; moe,
the same with ``models.moe`` in place of the MLP after the head layers;
ssm, a mamba2 mixer (``models.ssm``) and no FFN; hybrid, ``rglru``
(``models.rglru``) or ``local`` mixers, each with an MLP; encdec
(whisper), dense decoder blocks with a cross-attention (``normx``,
``xattn``) after the self-attention, over the output of an encoder
(``Params.encoder``: ``cfg.enc_layers`` non-causal ``attn`` blocks over
the stubbed frame embeddings ``enc_frames`` plus sinusoidal positions,
no final norm); vlm (qwen2-vl), dense blocks over the stubbed image
embeddings ``img_embeds`` prepended to the text, with M-RoPE positions
(3, B, S) from the batch.

Entry points:
  init(generator)                          -> params
  forward(params, batch)                   -> (logits, aux)
  loss_fn(params, batch)                   -> (loss, metrics)
  prefill(params, batch, max_len)          -> (last logits, cache)
  decode_step(params, tokens, cache, pos)  -> (logits, cache)
  init_cache(batch_size, max_len, device)  -> cache
  encode_for_decode(params, batch, cache)  -> cache (encdec)

The cache is a list with one dict per layer: ``{"k", "v"}`` for
attention, ``{"conv", "h"}`` for rglru and ``{"conv", "ssd"}`` for ssm
layers; ``prefill`` fills a fresh one and ``decode_step`` updates it in
place.  An encdec layer's dict also holds ``xk``, ``xv`` (B, enc_seq, KV,
D), the encoder's cross-attention keys and values, and ``enc_len`` (B,)
int32, one tensor shared by every layer, where the JAX package keeps
``cache["enc_len"]`` once.  Like the JAX package's, ``prefill`` and
``encode_for_decode`` set it to the full encoder length, not to the
batch's ``enc_len``: the prefill's cross-attention masks keys past the
batch's ``enc_len``, but decode attends to every frame.

MoE layers run at ``cfg.moe_capacity_factor`` in the forward and the
prefill and at ``n_experts`` (drop-free) in decode, or, where
``cfg.moe_dropless``, with no capacity anywhere (``models.moe``: a sort
by expert and the grouped kernel K6); ``aux``, their load-balancing loss
summed over layers, is added to ``loss_fn``'s loss (serving does not
compute it).
vlm image positions carry no next-token loss.

Remat (``cfg.remat``), when autograd records the forward: each block runs
under ``torch.utils.checkpoint`` (non-reentrant), where the JAX package
wraps each period of the layer scan.  ``"full"`` keeps only the block's
input; ``"dots"`` keeps, like ``jax.checkpoint_policies.checkpoint_dots``,
the outputs of the matrix products (``aten.mm``, ``bmm``, ``addmm``: the
q/k/v and output projections and the MLP's up, gate and down) and
recomputes the rest in the backward: the norms, RoPE, GeGLU and, on the
card, attention, so K4 runs twice per layer and step, in the forward and
in the recompute before K4b.  Remat changes no value.

On the mesh path (DTensor parameters and batch, ``Trainer(mesh=...)``)
the positions, masks and aux zero made here are placed like the batch;
each layer's output (a partial sum over ``model`` after a row-split
product) is reduced before it joins the residual stream, which stays
split by batch only;
parameters that FSDP splits over a data axis are gathered per block,
inside its checkpoint (so the gather is redone in the recompute, as
ZeRO-3 does); the loss reduces its log-sum-exp over the mesh dims that
split the vocabulary; and "dots" saves the DTensor products as it saves
plain ones.  Serving runs there too: ``prefill`` of a placed batch makes
its cache placed by ``cache_shardings`` (``init_cache(mesh=)``) and fills
each rank's shard; ``decode_step`` takes DTensor tokens and a placed
cache (``long_context``: its sequence split over ``data``), writes each
new key on the rank that holds its slot and gathers a sequence-split
cache for attention (DTensor's all-gather).

``cfg.ablate_mixer`` (the dry run's diagnostic) skips every block's
sequence mixer, as the JAX package does; ``cfg.attn_scores_dtype`` other
than float32 is refused (K4 and its plain version score in float32).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device, trace
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.parallel import dtensor as D

Cache = List[Dict[str, torch.Tensor]]
ATTENTION = ("attn", "local")


# ===================================================================== blocks
def _block_init(g: torch.Generator, cfg: ModelConfig, kind: str,
                moe: bool, cross: bool = False) -> nn.ModuleDict:
    dt = L.dtype_of(cfg.dtype)
    p = {"norm1": L.rmsnorm_init(cfg.d_model, dt, g.device)}
    if kind in ATTENTION:
        p["attn"] = A.attn_init(g, cfg)
    elif kind == "rglru":
        p["rglru"] = R.rglru_init(g, cfg)
    elif kind == "ssm":
        p["ssm"] = S.ssm_init(g, cfg)
        return nn.ModuleDict(p)                    # mamba2: mixer only
    else:
        raise ValueError(kind)
    if cross:
        p["normx"] = L.rmsnorm_init(cfg.d_model, dt, g.device)
        p["xattn"] = A.attn_init(g, cfg, cross=True)
    p["norm2"] = L.rmsnorm_init(cfg.d_model, dt, g.device)
    if moe:
        p["moe"] = M.moe_init(g, cfg)
    else:
        p["mlp"] = L.mlp_init(g, cfg, cfg.d_ff)
    return nn.ModuleDict(p)


def _block_apply_train(p, cfg: ModelConfig, kind: str, h, positions,
                       enc_out=None, enc_len=None, cache=None
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block over the full sequence.  Returns (h, the MoE aux loss or
    None).  With ``cache`` (prefill) the block's K/V, or its recurrent
    state, are written into it with decode-compatible addressing, and a
    cross-attention's keys and values over ``enc_out`` too.  DTensor
    parameters split over a data axis (FSDP) are gathered first."""
    if D.is_dt(p["norm1"]["scale"]):
        p = D.gather_data(p)
    x = L.rmsnorm(p["norm1"], h, cfg.norm_eps)
    if cfg.ablate_mixer:
        # the dry run's diagnostic, as the JAX package's: no sequence
        # mixer, and nothing written to its cache
        y = None
    elif kind in ATTENTION:
        if cache is not None:
            y, (k, v) = A.attend_train(p["attn"], cfg, x, positions,
                                       kind=kind, return_kv=True)
            A.fill_kv_cache(cache["k"], cache["v"], k, v, kind, cfg.window)
        else:
            y = A.attend_train(p["attn"], cfg, x, positions, kind=kind)
    else:
        apply = R.rglru_apply_train if kind == "rglru" \
            else S.ssm_apply_train
        if cache is not None:
            y, state = apply(p[kind], cfg, x, return_state=True)
            for k, v in state.items():
                cache[k].copy_(v)
        else:
            y = apply(p[kind], cfg, x)
    if y is not None:
        h = h + D.settle(y)
    if "xattn" in p:
        xx = L.rmsnorm(p["normx"], h, cfg.norm_eps)
        y, (xk, xv) = A.attend_train(p["xattn"], cfg, xx, None, kind="cross",
                                     enc_out=enc_out, enc_len=enc_len,
                                     return_kv=True)
        if cache is not None:
            cache["xk"].copy_(xk)
            cache["xv"].copy_(xv)
        h = h + D.settle(y)
    if "norm2" not in p:                           # mamba2 blocks: no FFN
        return h, None
    x2 = L.rmsnorm(p["norm2"], h, cfg.norm_eps)
    if "moe" in p:
        y, aux = M.moe_apply(p["moe"], cfg, x2, with_aux=cache is None)
        return h + y, aux
    return h + D.settle(L.mlp_apply(p["mlp"], x2, cfg.mlp_kind)), None


def _block_apply_decode(p, cfg: ModelConfig, kind: str, h, cache, pos,
                        positions=None):
    """One block, single token; updates ``cache`` in place.  DTensor
    parameters split over a data axis (FSDP) are gathered first."""
    if D.is_dt(p["norm1"]["scale"]):
        p = D.gather_data(p)
    x = L.rmsnorm(p["norm1"], h, cfg.norm_eps)
    if kind in ATTENTION:
        y, _, _ = A.attend_decode(p["attn"], cfg, x, cache["k"], cache["v"],
                                  pos, kind=kind, positions=positions)
    elif kind == "rglru":
        y, _ = R.rglru_apply_decode(p["rglru"], cfg, x, cache)
    else:
        y, _ = S.ssm_apply_decode(p["ssm"], cfg, x, cache)
    h = h + D.settle(y)
    if "xattn" in p:
        xx = L.rmsnorm(p["normx"], h, cfg.norm_eps)
        h = h + D.settle(A.attend_decode_cross(
            p["xattn"], cfg, xx, cache["xk"], cache["xv"], cache["enc_len"]))
    if "norm2" not in p:
        return h
    x2 = L.rmsnorm(p["norm2"], h, cfg.norm_eps)
    if "moe" in p:
        # drop-free capacity: a one-token step must keep its experts
        y, _ = M.moe_apply(p["moe"], cfg, x2,
                           capacity_factor=float(cfg.n_experts),
                           with_aux=False)
        return h + y
    return h + D.settle(L.mlp_apply(p["mlp"], x2, cfg.mlp_kind))


def _tree(m):
    """A ParameterDict / ModuleDict as nested dicts of its tensors."""
    if isinstance(m, (nn.ParameterDict, nn.ModuleDict)):
        return {k: _tree(v) for k, v in m.items()}
    return m


class Params(nn.Module):
    """The model's parameters: ``embed`` ({"tok", "lm_head"}), ``blocks``
    (one ModuleDict per layer, absolute order), ``final_norm``
    ({"scale"}) and, for encdec, ``encoder`` (one ModuleDict per encoder
    layer; None for the other families)."""

    def __init__(self, embed: nn.ParameterDict, blocks: List[nn.ModuleDict],
                 final_norm: nn.ParameterDict,
                 encoder: Optional[List[nn.ModuleDict]] = None):
        super().__init__()
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.encoder = None if encoder is None else nn.ModuleList(encoder)

    def tree(self) -> Dict:
        """The same parameter tensors as a tree of dicts and lists
        (``repro_torch.train.tree``): {"embed", "blocks": [per layer],
        "final_norm"} and, for encdec, "encoder": [per layer]; the form
        the optimizer and checkpoints take."""
        t = {"embed": _tree(self.embed),
             "blocks": [_tree(blk) for blk in self.blocks],
             "final_norm": _tree(self.final_norm)}
        if self.encoder is not None:
            t["encoder"] = [_tree(blk) for blk in self.encoder]
        return t


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """-log softmax(logits)[target] over the last dim, float32.  Where a
    mesh dim of more than one rank splits the vocabulary of DTensor
    logits it is computed as max, log-sum-exp and the target's logit, each
    reduced over those mesh dims, so that no rank gathers the logits
    whole; otherwise row by row on each rank's local rows."""
    if not D.is_dt(logits):
        return _nll_rows(logits, targets)
    v = logits.dim() - 1
    if not any(p.is_shard(v) and logits.device_mesh.size(i) > 1
               for i, p in enumerate(logits.placements)):
        return D.local_call(_nll_rows, logits, targets, like=logits,
                            out_placements=D.batch_placements(logits))
    top = D.settle(logits.detach().amax(dim=-1, keepdim=True))
    z = logits - top
    lse = torch.log(D.settle(torch.exp(z).sum(dim=-1)))
    picked = D.settle(torch.gather(z, -1, targets[..., None]))[..., 0]
    return lse - picked


def _nll_rows(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0]


# ==================================================================== model
@dataclasses.dataclass
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.attn_scores_dtype != "float32":
            raise ValueError(
                f"attn_scores_dtype {self.cfg.attn_scores_dtype!r}: K4 and "
                f"its plain version score in float32 only")

    @property
    def kinds(self) -> Tuple[str, ...]:
        """Each layer's kind in absolute order: ``cfg.first_k_dense`` head
        layers of kind ``attn``, then the layer pattern tiled over the
        rest (its leftover layers are the JAX package's tail)."""
        cfg = self.cfg
        n_head, pat = cfg.first_k_dense, cfg.layer_pattern
        return ("attn",) * n_head + tuple(
            pat[i % len(pat)] for i in range(cfg.n_layers - n_head))

    def init(self, generator: torch.Generator) -> Params:
        """Random weights drawn from ``generator`` on its device, at the JAX
        package's scales (the numbers differ: another generator)."""
        cfg, g = self.cfg, generator
        cross = cfg.family == "encdec"
        embed = L.embed_init(g, cfg)
        blocks = [_block_init(g, cfg, kind, cfg.moe_layer(i), cross=cross)
                  for i, kind in enumerate(self.kinds)]
        encoder = ([_block_init(g, cfg, "attn", False)
                    for _ in range(cfg.enc_layers)] if cross else None)
        return Params(embed, blocks,
                      L.rmsnorm_init(cfg.d_model, L.dtype_of(cfg.dtype),
                                     g.device), encoder)

    def init_eval(self) -> Params:
        """The parameters' shapes and dtypes without their memory: ``init``
        under ``FakeTensorMode`` (the JAX package's abstract
        ``init_eval``)."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            return self.init(torch.Generator())

    # ------------------------------------------------------------- forward
    def _embed_inputs(self, params: Params, batch: Dict[str, torch.Tensor]):
        """Token embeddings, with vlm's image embeddings prepended.
        Returns (h, positions): (B, S) positions 0..S-1, or vlm's (3, B, S)
        M-RoPE positions from the batch."""
        h = L.embed_tokens(D.gather_data(params.embed), batch["tokens"])
        if self.cfg.family == "vlm":
            h = torch.cat([batch["img_embeds"].to(h.dtype), h], dim=1)
            return h, batch["positions"]
        b, s = h.shape[:2]
        return h, D.place_like(torch.arange(s, device=h.device).expand(b, s),
                               h)

    def _encode(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Optional[torch.Tensor]:
        """The encoder's output over ``batch["enc_frames"]`` (B, T, d), for
        encdec (None for the other families): the frames in the model
        dtype plus sinusoidal positions, then the encoder blocks."""
        cfg = self.cfg
        if cfg.family != "encdec":
            return None
        dt = L.dtype_of(cfg.dtype)
        h = batch["enc_frames"].to(dt)
        h = h + D.place_like(
            L.sinusoid_on(h.shape[1], cfg.d_model, dt, h.device)[None], h,
            None)
        for p in params.encoder:
            p = D.gather_data(p)
            x = L.rmsnorm(p["norm1"], h, cfg.norm_eps)
            h = h + D.settle(A.attend_encoder(p["attn"], cfg, x))
            x2 = L.rmsnorm(p["norm2"], h, cfg.norm_eps)
            h = h + D.settle(L.mlp_apply(p["mlp"], x2, cfg.mlp_kind))
        return D.reduced_grad(h)         # no final norm reduces it

    def _logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        h = L.rmsnorm(params.final_norm, h, cfg.norm_eps)
        return L.lm_logits(D.gather_data(params.embed), h,
                           cfg.tie_embeddings,
                           out_dtype=L.dtype_of(cfg.logits_dtype),
                           true_vocab=cfg.vocab)

    def _block(self, p, kind: str, h, positions, enc_out, enc_len):
        """One block, under ``cfg.remat`` when autograd records.  Returns
        (h, aux or None)."""
        remat = self.cfg.remat
        if remat == "none" or not torch.is_grad_enabled():
            return _block_apply_train(p, self.cfg, kind, h, positions,
                                      enc_out, enc_len)
        if remat == "dots":
            context = functools.partial(
                ckpt.create_selective_checkpoint_contexts, _save_dots)
        elif remat == "full":
            context = ckpt.noop_context_fn
        else:
            raise ValueError(f"remat {remat!r}")
        return ckpt.checkpoint(_block_apply_train, p, self.cfg, kind, h,
                               positions, enc_out, enc_len,
                               use_reentrant=False, context_fn=context)

    def forward(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  Returns (logits (B, S, V), aux loss)."""
        h, positions = self._embed_inputs(params, batch)
        enc_out = self._encode(params, batch)
        enc_len = batch.get("enc_len") if enc_out is not None else None
        aux = D.place_like(torch.zeros((), dtype=torch.float32,
                                       device=h.device), h, None)
        for p, kind in zip(params.blocks, self.kinds):
            h, a = self._block(p, kind, h, positions, enc_out, enc_len)
            if a is not None:
                aux = aux + a
        return self._logits(params, h), aux

    # ---------------------------------------------------------------- loss
    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy over ``batch["targets"]`` (any integer
        dtype), weighted by ``batch["loss_mask"]`` where given; for vlm the
        image positions carry no loss (targets 0, weight 0 there, and
        ``loss_mask`` is not read).  Returns (ce + aux, {"ce", "aux",
        "ppl_proxy"}), 0-d float32 tensors."""
        logits, aux = self.forward(params, batch)
        targets = batch["targets"].to(torch.int64)
        if self.cfg.family == "vlm":
            n_img = batch["img_embeds"].shape[1]
            targets = F.pad(targets, (n_img, 0))
            mask = D.place_like(
                (torch.arange(targets.shape[1], device=targets.device)
                 >= n_img).to(torch.float32).expand(targets.shape), targets)
        else:
            mask = batch.get("loss_mask")
            if mask is None:
                mask = D.place_like(torch.ones(targets.shape,
                                               dtype=torch.float32,
                                               device=targets.device),
                                    targets)
        nll = _nll(logits.to(torch.float32), targets)
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = (nll * mask).sum() / denom
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux,
                      "ppl_proxy": torch.exp(torch.clamp(ce, max=20.0))}

    # -------------------------------------------------------------- prefill
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor],
                max_len: int) -> Tuple[torch.Tensor, Cache]:
        """Process a full prompt.  Returns (last-position logits (B, V),
        filled cache); ``decode_step`` continues from position S (for vlm
        S counts the image tokens)."""
        h, positions = self._embed_inputs(params, batch)
        enc_out = self._encode(params, batch)
        enc_len = batch.get("enc_len") if enc_out is not None else None
        cache = self.init_cache(h.shape[0], max_len, h.device,
                                mesh=h.device_mesh if D.is_dt(h) else None)
        for p, c, kind in zip(params.blocks, cache, self.kinds):
            h, _ = _block_apply_train(p, self.cfg, kind, h, positions,
                                      enc_out, enc_len, cache=c)
        if enc_out is not None:                 # as the JAX package does
            cache[0]["enc_len"].fill_(enc_out.shape[1])
        return self._logits(params, h[:, -1:])[:, 0], cache

    # --------------------------------------------------------------- cache
    def init_cache(self, batch: int, max_len: int, device="cuda", mesh=None,
                   long_context: bool = False) -> Cache:
        """A zero cache for ``batch`` sequences of up to ``max_len``
        positions.  With ``mesh`` each tensor is a DTensor placed by
        ``parallel.sharding.cache_shardings`` (``long_context``: the
        sequence split of a batch of 1), made from this rank's shard alone;
        the encdec ``enc_len`` stays one tensor shared by every layer."""
        if mesh is not None:
            return self._placed_cache(batch, max_len, device, mesh,
                                      long_context)
        cfg = self.cfg
        dev = resolve_device(device)
        dt = L.dtype_of(cfg.dtype)
        cache = []
        enc_len = (torch.zeros(batch, dtype=torch.int32, device=dev)
                   if cfg.family == "encdec" else None)
        for kind in self.kinds:
            if kind == "rglru":
                cache.append(R.rglru_decode_init(cfg, batch, dt, dev))
                continue
            if kind == "ssm":
                cache.append(S.ssm_decode_init(cfg, batch, dt, dev))
                continue
            c = min(cfg.window, max_len) if (kind == "local" and cfg.window) \
                else max_len
            shape = (batch, c, cfg.n_kv_heads, cfg.head_dim)
            layer = {"k": torch.zeros(shape, dtype=dt, device=dev),
                     "v": torch.zeros(shape, dtype=dt, device=dev)}
            if enc_len is not None:
                xshape = (batch, cfg.enc_seq, cfg.n_kv_heads, cfg.head_dim)
                layer.update(xk=torch.zeros(xshape, dtype=dt, device=dev),
                             xv=torch.zeros(xshape, dtype=dt, device=dev),
                             enc_len=enc_len)
            cache.append(layer)
        return cache

    def _placed_cache(self, batch: int, max_len: int, device, mesh,
                      long_context: bool) -> Cache:
        from repro_torch.parallel import sharding as shlib
        shapes = self.init_cache(batch, max_len, "meta")
        specs = shlib.cache_shardings(shapes, self.cfg, mesh,
                                      long_context=long_context)
        made = {}

        def place(t, spec):
            if id(t) not in made:                  # the shared enc_len
                made[id(t)] = D.zeros_placed(
                    t.shape, t.dtype, mesh, shlib.placements(spec, mesh),
                    device)
            return made[id(t)]
        return [{k: place(t, spec[k]) for k, t in layer.items()}
                for layer, spec in zip(shapes, specs)]

    # -------------------------------------------------------------- decode
    def decode_step(self, params: Params, tokens: torch.Tensor, cache: Cache,
                    pos) -> Tuple[torch.Tensor, Cache]:
        """tokens (B, 1); pos: absolute position (int or (B,)).  Returns
        (logits (B, V), cache), the cache updated in place.  On a mesh:
        DTensor parameters, tokens placed by ``batch_shardings`` and a
        cache placed by ``cache_shardings`` (``init_cache(mesh=)``); a
        plain ``pos``."""
        h = L.embed_tokens(D.gather_data(params.embed), tokens)
        if not isinstance(pos, torch.Tensor):
            trace.count("host_syncs")       # a host value copied in
        pos = torch.as_tensor(pos, dtype=torch.int64, device=h.device)
        positions = self.decode_positions(pos, h.shape[0])
        for p, c, kind in zip(params.blocks, cache, self.kinds):
            h = _block_apply_decode(p, self.cfg, kind, h, c, pos, positions)
        return self._logits(params, h)[:, 0], cache

    def decode_positions(self, pos: torch.Tensor, batch: int
                         ) -> Optional[torch.Tensor]:
        """RoPE positions of one decode step at absolute ``pos`` (0-d or
        (B,)): M-RoPE's (3, B, 1), all three components ``pos``; None
        (the layers use ``pos``) otherwise."""
        if not self.cfg.mrope:
            return None
        return pos.expand(batch)[None, :, None].expand(3, batch, 1)

    def encode_for_decode(self, params: Params,
                          batch: Dict[str, torch.Tensor], cache: Cache
                          ) -> Cache:
        """Whisper: run the encoder over ``batch["enc_frames"]`` and write
        every layer's cross-attention keys and values into ``cache`` in
        place; ``enc_len`` becomes the full encoder length.  Returns the
        cache."""
        cfg = self.cfg
        enc = self._encode(params, batch)
        b, t = enc.shape[:2]
        for p, c in zip(params.blocks, cache):
            c["xk"].copy_((enc @ p["xattn"]["wk"]).reshape(
                b, t, cfg.n_kv_heads, cfg.head_dim))
            c["xv"].copy_((enc @ p["xattn"]["wv"]).reshape(
                b, t, cfg.n_kv_heads, cfg.head_dim))
        cache[0]["enc_len"].fill_(t)
        return cache


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
