"""The plain reference: decoder-only models in float32 PyTorch.

It reads a configuration file's ``model`` object and a tree of weights in
the layout of ``bench/weights.py``, and imports nothing of the program
under test.  Every product runs in float32 with TF32 off (``strict``).
It computes what the published block computes, with the departures its
configuration file lists: a hybrid layer (hymba) runs windowed GQA
attention with RoPE and a Mamba-2 (SSD) branch on the same normed input
and adds ``0.5 * (norm(attn) + norm(ssm))``; an MoE layer (granite) routes
each token to its top-k experts in float32 and drops what overflows an
expert's capacity, a sequence one group in the prompt and the batch's
tokens of one position one group after it, as the served model does.

``Prec`` rounds the operands of every dense product: ``FP32`` leaves them
as they are, ``FP8`` rounds each to float8 e4m3 with one scale a tensor
(the control: the same model a precision below bfloat16).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def strict() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Prec:
    """Operand rounding of the dense products."""

    def __init__(self, name: str):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        if self.name == "fp32":
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
        low = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (low - t.detach())   # the rounding passes gradients


FP32, FP8 = Prec("fp32"), Prec("fp8")


def rmsnorm(x, gain, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) \
        * gain.float()


def capacity(m: dict, tokens: int) -> int:
    """Slots an expert a group: capacity_factor * tokens * k / e, up to a
    multiple of 8, at least 8."""
    c = int(m.get("capacity_factor", 1.25) * tokens * m["experts_per_token"]
            / m["n_experts"])
    return max(8, -(-c // 8) * 8)


def rope(x, positions, theta):
    """x (B, H, T, D), positions (T,): the half-split rotation."""
    d2 = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(d2, dtype=torch.float32,
                                        device=x.device) / d2))
    ang = positions.float()[:, None] * inv[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p, h, m, prec, budget=1 << 28):
    """Causal (windowed) GQA attention of h (B, T, d) over itself."""
    b, t, _ = h.shape
    hq, hkv = m["n_heads"], m["n_kv_heads"]
    hd = m.get("d_head") or m["d_model"] // hq
    pos = torch.arange(t, device=h.device)

    def heads(w, n):
        return (prec(h) @ prec(w)).view(b, t, n, hd).transpose(1, 2)
    q = rope(heads(p["wq"], hq), pos, m.get("rope_theta", 1e4))
    k = rope(heads(p["wk"], hkv), pos, m.get("rope_theta", 1e4))
    v = heads(p["wv"], hkv)
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    mask = pos[None, :] <= pos[:, None]
    if m.get("window"):
        mask &= pos[None, :] > pos[:, None] - m["window"]
    out = torch.empty_like(q)
    rows = max(1, budget // (hq * t * t))
    for r in range(0, b, rows):
        s = prec(q[r:r + rows]) @ prec(k[r:r + rows]).transpose(-1, -2)
        s = (s * hd ** -0.5).masked_fill(~mask, float("-inf"))
        out[r:r + rows] = prec(torch.softmax(s, -1)) @ prec(v[r:r + rows])
    return prec(out.transpose(1, 2).reshape(b, t, hq * hd)) @ prec(p["wo"])


def ssm(p, h, m, prec, budget=1 << 28):
    """The Mamba-2 (SSD) branch of h (B, T, d), chunked in float32."""
    b, t, _ = h.shape
    d = m["d_model"]
    di = m.get("ssm_expand", 2) * d
    n = m["ssm_state"]
    hp = m.get("ssm_headdim", 64)
    nh = di // hp
    lc = m.get("ssm_chunk", 256)
    proj = prec(h) @ prec(p["in_proj"])
    z, xbc, dt_raw = proj[..., :di], proj[..., di:2 * di + 2 * n], \
        proj[..., 2 * di + 2 * n:]
    w = p["conv_w"].float()
    width = w.shape[0]
    xpad = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(xpad[:, i:i + t] * w[i] for i in range(width))
    xbc = F.silu(conv + p["conv_b"].float())
    xs = xbc[..., :di].reshape(b, t, nh, hp)
    bm, cm = xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt_raw + p["dt_bias"].float())
    a = dt * -torch.exp(p["A_log"].float())
    pad = (-t) % lc
    xdt = F.pad(xs * dt[..., None], (0, 0, 0, 0, 0, pad))
    a, bm, cm = (F.pad(u, (0, 0, 0, pad)) for u in (a, bm, cm))
    nc = (t + pad) // lc
    xdt = xdt.view(b, nc, lc, nh, hp)
    a, bm, cm = a.view(b, nc, lc, nh), bm.view(b, nc, lc, n), \
        cm.view(b, nc, lc, n)
    cum = torch.cumsum(a, dim=2)
    tri = torch.tril(torch.ones(lc, lc, dtype=torch.bool, device=h.device))
    y = torch.empty(b, nc, lc, nh, hp, device=h.device)
    rows = max(1, budget // (nc * lc * lc * nh))
    for r in range(0, b, rows):
        sl = slice(r, r + rows)
        g = torch.einsum("bcln,bcsn->bcls", cm[sl], bm[sl])
        seg = cum[sl][:, :, :, None, :] - cum[sl][:, :, None, :, :]
        dec = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                        float("-inf")))
        att = (g[..., None] * dec).permute(0, 1, 4, 2, 3)  # (b, c, h, l, s)
        y[sl] = (att @ xdt[sl].permute(0, 1, 3, 2, 4)).permute(0, 1, 3, 2, 4)
    # chunk states and the inter-chunk recurrence
    last = cum[:, :, -1:, :]
    xw = xdt * torch.exp(last - cum)[..., None]             # (b, c, s, h, p)
    sc = (xw.reshape(b, nc, lc, nh * hp).transpose(-1, -2) @ bm) \
        .view(b, nc, nh, hp, n)
    state = torch.zeros(b, nh, hp, n, device=h.device)
    inter = []
    for c in range(nc):
        inter.append(state)
        state = state * torch.exp(last[:, c, 0])[:, :, None, None] + sc[:, c]
    inter = torch.stack(inter, dim=1)
    off = cm @ inter.reshape(b, nc, nh * hp, n).transpose(-1, -2)
    y = y + off.view(b, nc, lc, nh, hp) * torch.exp(cum)[..., None]
    y = y.reshape(b, nc * lc, nh, hp)[:, :t]
    y = y + p["D"].float()[:, None] * xs
    y = rmsnorm(y.reshape(b, t, di) * F.silu(z), p["norm_gain"],
                m.get("norm_eps", 1e-5))
    return prec(y) @ prec(p["out_proj"])


def mlp(p, h, prec):
    g = prec(h) @ prec(p["w_gate"])
    u = prec(h) @ prec(p["w_up"])
    return prec(F.silu(g) * u) @ prec(p["w_down"])


def moe(p, h, m, prec, prompt_len: int, aux=None):
    """Top-k experts of h (B, T, d): positions below ``prompt_len`` one
    group a sequence, each later position one group over the batch; a
    group's slots an expert taken in token order, the rest dropped."""
    b, t, d = h.shape
    e, k = m["n_experts"], m["experts_per_token"]
    probs = torch.softmax(h.float() @ p["router"].float(), dim=-1)
    top, ids = torch.topk(probs, k, dim=-1)
    if aux is not None:   # the Switch load-balance term of the block
        frac = F.one_hot(ids, e).float().mean(dim=(0, 1, 2))
        aux.append(e * torch.sum(frac * probs.mean(dim=(0, 1))))
    gates = top / top.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(ids, e)                            # (B, T, k, e)
    keep = torch.zeros(b, t, k, dtype=torch.bool, device=h.device)
    sp = min(prompt_len, t)
    if sp:
        oh = onehot[:, :sp].reshape(b, sp * k, e)
        rank = (torch.cumsum(oh, dim=1) - 1) * oh
        keep[:, :sp] = (rank.sum(-1) < capacity(m, sp)).view(b, sp, k)
    if t > sp:   # (T - sp) groups of the batch's tokens at one position
        oh = onehot[:, sp:].transpose(0, 1).reshape(t - sp, b * k, e)
        rank = (torch.cumsum(oh, dim=1) - 1) * oh
        kept = (rank.sum(-1) < capacity(m, b)).view(t - sp, b, k)
        keep[:, sp:] = kept.transpose(0, 1)
    w = (gates * keep).reshape(-1, k)
    flat_ids = ids.reshape(-1, k)
    x = h.reshape(-1, d)
    y = torch.zeros_like(x)
    for j in range(e):
        hit = (flat_ids == j) & (w > 0)
        tok, slot = torch.nonzero(hit, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x.index_select(0, tok)
        he = F.silu(prec(xe) @ prec(p["w_gate"][j])) \
            * (prec(xe) @ prec(p["w_up"][j]))
        ye = prec(he) @ prec(p["w_down"][j])
        y.index_add_(0, tok, ye * w[tok, slot][:, None])
    return y.view(b, t, d)


def layer(lp, x, m, prec, prompt_len, aux=None):
    eps = m.get("norm_eps", 1e-5)
    h = rmsnorm(x, lp["attn_norm"], eps)
    if m["family"] == "hybrid":
        a = attention(lp["attn"], h, m, prec)
        s = ssm(lp["ssm"], h, m, prec)
        x = x + 0.5 * (rmsnorm(a, lp["attn_gain"], eps)
                       + rmsnorm(s, lp["ssm_gain"], eps))
    else:
        x = x + attention(lp["attn"], h, m, prec)
    h = rmsnorm(x, lp["mlp_norm"], eps)
    if m.get("n_experts"):
        return x + moe(lp["moe"], h, m, prec, prompt_len, aux)
    return x + mlp(lp["mlp"], h, prec)


def served_logits(m: dict, params: dict, prompts: torch.Tensor,
                  served: torch.Tensor, prec: Prec = FP32) -> torch.Tensor:
    """The logits (B, G, V) float32 that chose each served token: the
    model over the prompts (B, S) followed by the served tokens (B, G)
    but the last, read at positions S - 1 .. S + G - 2."""
    with torch.no_grad():
        s, g = prompts.shape[1], served.shape[1]
        tokens = torch.cat([prompts, served[:, :-1]], dim=1).long()
        x = params["embed"][tokens].float()
        for lp in params["layers"]:
            x = layer(lp, x, m, prec, s)
        x = rmsnorm(x[:, s - 1:], params["final_norm"],
                    m.get("norm_eps", 1e-5))
        table = params["embed"] if m.get("tie_embeddings") \
            else params["unembed"]
        out = torch.empty(x.shape[0], g, table.shape[0], device=x.device)
        for r in range(x.shape[0]):
            out[r] = prec(x[r]) @ prec(table).t()
        return out


# -- training ---------------------------------------------------------------

def _forward_loss(m: dict, p: dict, tokens, labels, prec: Prec,
                  z_loss: float = 1e-4):
    """Token-mean cross entropy with the z-loss (``z_loss * lse**2``) of
    one micro-batch, plus the MoE load-balance terms times
    ``router_aux_weight``; each layer recomputed in the backward pass."""
    from torch.utils.checkpoint import checkpoint

    def body(h, lp):
        aux = []
        out = layer(lp, h, m, prec, h.shape[1], aux)
        return out, (aux[0] if aux else torch.zeros((), device=h.device))
    x = p[("embed",)][tokens.long()]
    aux = torch.zeros((), device=x.device)
    for i in range(m["n_layers"]):
        x, a = checkpoint(body, x, _layer_tree(p, i), use_reentrant=False)
        aux = aux + a
    x = rmsnorm(x, p[("final_norm",)], m.get("norm_eps", 1e-5))
    table = p[("embed",)] if m.get("tie_embeddings") else p[("unembed",)]
    logits = prec(x) @ prec(table).t()
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold + z_loss * lse ** 2).mean() \
        + m.get("router_aux_weight", 0.01) * aux


def _layer_tree(p: dict, i: int) -> dict:
    """Layer ``i``'s leaves of a path-keyed parameter dict as a tree."""
    out: dict = {}
    for path, t in p.items():
        if path[:2] != ("layers", i):
            continue
        node = out
        for key in path[2:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return out


def _lr(step: int, tr: dict) -> float:
    """Linear warmup to the peak, then a cosine to a tenth of it."""
    w, total, peak = tr["warmup_steps"], tr["total_steps"], tr["peak_lr"]
    if step < w:
        return peak * step / max(w, 1)
    prog = min(max((step - w) / max(total - w, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


def train_steps(m: dict, tr: dict, seed: int, device, prec: Prec = FP32,
                steps: int = 3, rows=None) -> dict:
    """AdamW on the configuration's model from the seed's parameters over
    the seed's first ``steps`` batches, in float32 arithmetic over the
    configuration's stored parameters (the weights rounded to the
    activation dtype after each update, a float32 master kept): each
    step's loss, each
    leaf's gradient norm at step 1 as the optimizer takes it (after the
    clip), and each leaf's change over the steps.  ``rows`` keeps only
    those rows of every batch (a fault: the mean over the rest)."""
    from bench import train_inputs
    b1, b2, eps, wd, clip = 0.9, 0.95, 1e-8, 0.1, 1.0
    act = getattr(torch, m.get("dtype", "bfloat16"))
    low = {path for path, _, how in train_inputs.param_specs(m)
           if train_inputs.stored_low(how)}
    master = dict(train_inputs.init_params(m, seed, device))
    start = {path: t.clone() for path, t in master.items()}
    mom = {path: torch.zeros_like(t) for path, t in master.items()}
    vel = {path: torch.zeros_like(t) for path, t in master.items()}
    out = {"loss": [], "grad": {}, "change": {}}
    for step in range(steps):
        batch = train_inputs.global_batch(m["vocab_size"], tr["seq_len"],
                                          tr["global_batch"], seed, step)
        keep = list(range(tr["global_batch"])) if rows is None else rows
        micro = tr["micro_per_shard"]
        blocks = [keep[i:i + micro] for i in range(0, len(keep), micro)]
        # the stored parameters: weights in the activation dtype, read in
        # float32, the float32 master beside them (the configuration's)
        p = {path: (t.to(act).float() if path in low else t.clone())
             .requires_grad_(True) for path, t in master.items()}
        grads = {path: torch.zeros_like(t) for path, t in p.items()}
        total = 0.0
        for rs in blocks:   # the loss is the mean of the micro-batches'
            tok = torch.as_tensor(batch["tokens"][rs], device=device)
            lab = torch.as_tensor(batch["labels"][rs], device=device)
            loss = _forward_loss(m, p, tok, lab, prec) / len(blocks)
            g = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
            for path, gi in zip(p, g):
                if gi is not None:
                    grads[path] += gi
            total += float(loss.detach())
        out["loss"].append(total)
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(clip / torch.clamp_min(gnorm, 1e-12), max=1.0)
            t = step + 1
            lr = _lr(t, tr)
            b1c, b2c = 1 - b1 ** t, 1 - b2 ** t
            for path, w in master.items():
                g = grads[path] * scale
                if step == 0:
                    out["grad"][path] = float(torch.linalg.vector_norm(g))
                mom[path].mul_(b1).add_((1 - b1) * g)
                vel[path].mul_(b2).add_((1 - b2) * g * g)
                upd = (mom[path] / b1c) / (torch.sqrt(vel[path] / b2c) + eps)
                # a layer's leaves are one dim more (the stacked layers)
                if w.dim() + (path[0] == "layers") >= 2:
                    upd = upd + wd * w
                w.sub_(lr * upd)
    with torch.no_grad():
        for path, w in master.items():
            out["change"][path] = float(torch.linalg.vector_norm(
                w - start[path]))
    return out
