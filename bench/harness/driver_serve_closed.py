"""Traffic of kind "serve_closed": closed-loop analog serving of a HARP
deployment made in set-up, through the continuous scheduler.

`clients` clients each send their next request as soon as the last one
completes.  Request sizes cycle through a block that holds every prompt
length and every new-token count of the mix's ranges once, paired by
the seed, so every seed serves the same sizes in another order; prompt
tokens are drawn from the seed.  The harness drives the scheduler's public calls
(`admit`, which ends in the first token's host fetch, and `step`, which
ends in the step's one fetch) and stamps each request on the host clock
when it is sent, when its first token is back and when its last is.

Correctness: the window keeps, on the card and without a sync, the
`TOP_K` largest logits (values and token ids) of every row the
scheduler picks a token from, prefill and decode, with the row's
request id and token index.  After the window, a sample of completed
requests drawn from the seed, the one with the most tokens among them,
is run through the reference: its own deploy of the same weights with
the same key, then the analog forward over each prompt and its served
tokens, each row with the read noise of the engine access that computed
it.  The numbers held to their limits are the mean, over the sampled
served tokens, of the gap by which a served token's reference logit
lies below the reference's best at that position; the share of tokens
with any gap; and the mean, over those rows' kept logits, of their
distance from the reference's logit of the same token.
"""

from __future__ import annotations

import collections
import sys
import time

import numpy as np
import torch

from reference import analog_lm, rng as ref_rng, wv as ref_wv
from work import kernels as kw
from work import model_flops

from . import stats, weights


# Request ids of the requests that fill the slots in set-up.
FILL_RID = 1 << 28
# Logits kept of each row the scheduler picks a token from.
TOP_K = 8


def _keys(seed: int, device):
    root = ref_rng.PRNGKey(seed, device)
    return ref_rng.fold_in(root, 1), ref_rng.fold_in(root, 2)   # deploy, read noise


def _cfg_dict(cfg) -> dict:
    return dict(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, d_ff=cfg.d_ff, vocab_size=cfg.vocab_size,
                n_layers=cfg.n_layers)


def setup(cell: dict, seed: int, device) -> dict:
    from repro_torch.cim import CIMConfig, CIMExecutor
    from repro_torch.core import WVConfig, WVMethod
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.serving import ContinuousScheduler, ServeEngine

    t = cell["traffic"]
    cfg = weights.model_config(cell["config"])
    params = weights.make_params(cfg, seed, device)
    k_dep, k_noise = _keys(seed, device)
    deployed, _ = deploy_arrays(k_dep, params, WVConfig(method=WVMethod(t["method"])),
                                batched=True, device=device)
    acfg = CIMConfig(dac_bits=t["dac_bits"], adc_bits=t["adc_bits"],
                     sigma_read_lsb=t["read_noise_lsb"])
    executor = CIMExecutor(deployed, acfg, k_noise)
    engine = ServeEngine(cfg, None, executor=executor)
    (p_lo, p_hi), (n_lo, n_hi) = t["prompt_len"], t["new_tokens"]
    sched = ContinuousScheduler(engine, n_slots=t["clients"], max_len=p_hi + n_hi + 8,
                                device=device)
    sched.warmup(prompt_range=(p_lo, p_hi))
    gen = np.random.default_rng(seed)
    lens, news = np.arange(p_lo, p_hi + 1), np.arange(n_lo, n_hi + 1)
    order = [(int(p), int(n)) for p, n in zip(gen.permutation(lens), gen.permutation(news))]
    st = dict(cell=cell, cfg=cfg, params=params, seed=seed, device=device,
              executor=executor, sched=sched, pool=order, gen=gen,
              k_dep=k_dep, k_noise=k_noise)
    # Fill every slot before the window, with budgets spread over
    # 2..n_hi so that completions, and the clients' next requests, are
    # spread from the window's first step on.
    live = {}
    for i in range(t["clients"]):
        req, r = _request(st, FILL_RID + i, 0.0)
        req.max_new = r["max_new"] = 2 + i * (n_hi - 1) // t["clients"]
        sched.admit(req)
        r.update(n=1, access=[executor.access], warm=True)
        live[req.rid] = r
    st["live"] = live
    return st


def _request(st: dict, rid: int, sent: float):
    from repro_torch.serving import Request

    plen, new = st["pool"][rid % len(st["pool"])]
    prompt = st["gen"].integers(0, st["cfg"].vocab_size, size=plen).astype(np.int32)
    return Request(rid=rid, prompt=prompt, max_new=new), dict(
        rid=rid, sent=sent, first=None, done=None, n=0, access=[], prompt=prompt,
        max_new=new)


def keep_logits(sched) -> list:
    """Make `sched` keep the `TOP_K` largest logits of every row it picks
    a token from, as device tensors (no sync): a list of (values, token
    ids, request ids, token indices) per call.  `release_logits` undoes
    it."""
    pick = sched._select_tokens
    kept = []

    def select(logits, master, rids, gens):
        rows = logits.reshape(-1, logits.shape[-1])
        v, i = torch.topk(rows.to(torch.float32), TOP_K, dim=-1)
        kept.append((v, i, rids, gens))
        return pick(logits, master, rids, gens)

    sched._select_tokens = select
    return kept


def release_logits(sched, kept: list) -> dict:
    """Stop keeping logits; {(request id, token index): (values, ids)} on
    the host."""
    del sched._select_tokens
    out = {}
    for v, i, rids, gens in kept:
        v, i = v.cpu(), i.cpu()
        rids = torch.as_tensor(rids).reshape(-1).cpu().tolist()
        gens = torch.as_tensor(gens).reshape(-1).cpu().tolist()
        for row, (rid, gen) in enumerate(zip(rids, gens)):
            if rid >= 0:
                out[(int(rid), int(gen))] = (v[row], i[row])
    return out


def window(st: dict, seconds: float, tracer) -> dict:
    t = st["cell"]["traffic"]
    sched, ex = st["sched"], st["executor"]
    n_slots = t["clients"]
    live = st.pop("live")
    kept = keep_logits(sched)
    start_n = {rid: r["n"] for rid, r in live.items()}
    t0 = time.perf_counter()
    pending = collections.deque()
    next_rid = 0
    done, admits, steps, occ, traced = [], [], [], [], []
    t_end = t0
    while time.perf_counter() - t0 < seconds:
        if not tracer.active and tracer.summary is None and tracer.on \
                and time.perf_counter() - t0 >= t["trace_start_s"]:
            tracer.start()
            t_trace = time.perf_counter()
        while pending and sched.active_slots() < n_slots:
            req, r = pending.popleft()
            a0 = time.perf_counter()
            with tracer.span("bench.admit"):
                sched.admit(req)
            t_end = time.perf_counter()
            admits.append(t_end - a0)
            r.update(first=t_end, n=1, access=[ex.access])
            live[r["rid"]] = r
            if tracer.active:
                traced.append(("admit", len(r["prompt"])))
        if sched.active_slots():
            occ.append(sched.active_slots())
            s0 = time.perf_counter()
            with tracer.span("bench.step"):
                sched.step()
            t_end = time.perf_counter()
            steps.append(t_end - s0)
            if tracer.active:
                traced.append(("step", occ[-1]))
            for rid, r in list(live.items()):
                n = len(sched.records[rid].tokens)
                if n > r["n"]:
                    r["n"] = n
                    r["access"].append(ex.access)
                if n >= r["max_new"]:
                    r["done"] = t_end
                    r["served"] = list(sched.records[rid].tokens)
                    done.append(live.pop(rid))
                    pending.append(_request(st, next_rid, t_end))
                    next_rid += 1
        if tracer.active and time.perf_counter() - t_trace >= t["trace_s"]:
            tracer.stop()
    tracer.stop()
    every = done + list(live.values())
    return dict(t0=t0, t_end=t_end, requests=every, completed=done, admit_s=admits,
                step_s=steps, occupancy=occ, traced=traced, sent=next_rid,
                start_n=start_n, logits=release_logits(sched, kept))


def end_to_end(rec: dict) -> dict:
    span = rec["t_end"] - rec["t0"]
    tokens = sum(r["n"] - rec["start_n"].get(r["rid"], 0) for r in rec["requests"])
    sent = [r for r in rec["requests"] if not r.get("warm")]
    return {
        "serve_tokens_per_s": tokens / span,
        "ttft_p95_ms": 1e3 * stats.p95(stats.ttfts(sent)),
        "tpot_p95_ms": 1e3 * stats.p95(stats.tpots([r for r in sent if r["done"]])),
    }


def _leaf_shapes(st: dict) -> dict:
    """(K, M) of every analog leaf of one layer."""
    lay = st["params"]["layers"]
    return {k: tuple(lay[k].shape[1:]) for k in
            ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")}


def layer_context(st: dict, rec: dict, trace: dict | None) -> dict:
    t = st["cell"]["traffic"]
    planes = 2 * (t["dac_bits"] - 1)
    work: dict = {}
    for kind, tokens in rec["traced"]:
        for k, m in _leaf_shapes(st).values():
            r = min(128, k)
            work = kw.add(work, *kw.acim_vmm(planes * tokens, -(-k // r), 2, r, m),
                          times=st["cfg"].n_layers)
    c = _cfg_dict(st["cfg"])
    flops = 0.0
    for r in rec["requests"]:
        n0 = rec["start_n"].get(r["rid"], 0)
        plen = len(r["prompt"])
        flops += model_flops.request_flops(c, plen, r["n"]) - (
            model_flops.request_flops(c, plen, n0) if n0 else 0.0)
    return dict(kind="serve", trace=trace, kernel_work={"acim_vmm": work} if work else {},
                model_flops=flops, window_s=rec["t_end"] - rec["t0"],
                occupancy=rec["occupancy"], n_slots=t["clients"],
                admit_s=rec["admit_s"], step_s=rec["step_s"])


def release(st: dict, rec: dict) -> None:
    for k in ("sched", "executor"):
        st.pop(k, None)


def _sample(st: dict, rec: dict) -> list:
    t = st["cell"]["traffic"]
    done = sorted((r for r in rec["completed"] if not r.get("warm")),
                  key=lambda r: r["rid"])
    longest = max(done, key=lambda r: (r["n"] + len(r["prompt"]), -r["rid"]))
    rest = [r for r in done if r is not longest]
    gen = np.random.default_rng(st["seed"] + 1)
    k = min(t["check_requests"] - 1, len(rest))
    return [longest] + [rest[i] for i in sorted(gen.choice(len(rest), size=k, replace=False))]


def reference_model(st: dict, dtype=torch.float32) -> dict:
    """The reference's own deploy of the weights (every column) and the
    served model it gives."""
    cols = ref_wv.leaf_columns(st["params"])
    targets = torch.cat([c for _, _, c, _, _ in cols])
    uids = torch.arange(targets.shape[0], device=targets.device)
    g_all, _ = ref_wv.program(st["k_dep"], targets, uids, dtype=dtype, block=1 << 18)
    g = {name: g_all[base:base + c.shape[0]] for name, _, c, _, base in cols}
    uid = {name: i for i, name in enumerate(sorted(g))}
    t = st["cell"]["traffic"]
    analog, norms = {}, {}
    for name, leaf, c, scale, base in cols:
        short = name.split("'")[-2]
        if leaf.ndim == 3 and short in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
            k, m = leaf.shape[1:]
            tiles = analog_lm.slice_tiles(g[name], k, m, 128)
            analog[short] = (tiles, scale.reshape(-1).to(torch.float32), uid[name])
        else:
            norms[short] = ref_wv.dequantize_columns(g[name], leaf, scale)[0]
    cfg = st["cfg"]
    return dict(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim, rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
                tok_embed=st["params"]["tok_embed"], final_norm=st["params"]["final_norm"],
                norms=norms, analog=analog, master=st["k_noise"]), analog_lm.AnalogConfig(
                    t["dac_bits"], t["adc_bits"], t["read_noise_lsb"])


def sequences(reqs: list) -> list[dict]:
    """Each request's rows: the prompt (its prefill's access, ids by
    position) then every served token but the last (each at its decode
    step's access, id = the request id)."""
    seqs = []
    for r in reqs:
        plen = len(r["prompt"])
        served = r["served"]
        toks = np.concatenate([r["prompt"], np.asarray(served[:-1], np.int64)])
        access = [r["access"][0]] * plen + list(r["access"][1:])
        ids = list(range(plen)) + [r["rid"]] * (len(served) - 1)
        seqs.append(dict(tokens=torch.as_tensor(toks, dtype=torch.int64),
                         access=torch.as_tensor(access, dtype=torch.int64),
                         token_ids=torch.as_tensor(ids, dtype=torch.int64),
                         positions=torch.arange(len(toks))))
    return seqs


def gaps(logits: list, reqs: list, pick=None) -> torch.Tensor:
    """Per served token, the gap between its row's best reference logit
    and the reference logit of the token judged there (the served one,
    or the one `pick`'s logits put first)."""
    out = []
    for i, (lg, r) in enumerate(zip(logits, reqs)):
        plen = len(r["prompt"])
        rows = lg[plen - 1: plen - 1 + len(r["served"])]
        tok = (torch.as_tensor(r["served"], device=rows.device) if pick is None
               else torch.argmax(pick[i][plen - 1: plen - 1 + len(r["served"])], dim=-1))
        chosen = torch.gather(rows, 1, tok[:, None].to(torch.int64))[:, 0]
        out.append(torch.amax(rows, dim=-1) - chosen)
    return torch.cat(out)


def top_logits(lg: list, reqs: list) -> list:
    """Per sampled request, the `TOP_K` largest of each served token's
    row of `lg` (a list of per-request logits): (values, ids) pairs."""
    out = []
    for rows, r in zip(lg, reqs):
        plen = len(r["prompt"])
        v, i = torch.topk(rows[plen - 1: plen - 1 + len(r["served"])], TOP_K, dim=-1)
        out.append((v.cpu(), i.cpu()))
    return out


def kept_logits(rec: dict, reqs: list) -> list:
    """The program's kept logits of each sampled request's served tokens,
    in the shape `top_logits` gives.  A row the window did not keep
    reads as infinitely far from the reference."""
    out = []
    for r in reqs:
        vs, ids = [], []
        for gen in range(len(r["served"])):
            v, i = rec["logits"].get((r["rid"], gen), (torch.full((TOP_K,), float("inf")),
                                                      torch.zeros(TOP_K, dtype=torch.int64)))
            vs.append(v)
            ids.append(i)
        out.append((torch.stack(vs), torch.stack(ids)))
    return out


def logit_errors(ref: list, top: list, reqs: list) -> torch.Tensor:
    """Per kept logit of a served token's row, |value - the reference's
    logit of that token there|."""
    out = []
    for lg, (v, i), r in zip(ref, top, reqs):
        plen = len(r["prompt"])
        rows = lg[plen - 1: plen - 1 + len(r["served"])].cpu()
        out.append(torch.abs(v - torch.gather(rows, 1, i.to(torch.int64))).reshape(-1))
    return torch.cat(out)


def _numbers(g: torch.Tensor, err: torch.Tensor) -> dict:
    """The mean gap, the share of tokens with any gap, and the mean
    distance of the kept logits from the reference's.  The widest gap
    and the widest distance are printed but not held to a limit: float32
    rounding of the column sums flips ADC codes, which moves sound runs'
    widest gap to half the control's (PERF.md, Open questions)."""
    print(f"served tokens checked {g.numel()}, widest gap {float(torch.max(g))!r}, "
          f"kept logits {err.numel()}, rms distance "
          f"{float(torch.sqrt(torch.mean(err ** 2)))!r}, widest {float(torch.max(err))!r}",
          file=sys.stderr)
    return {"served_logit_gap_mean": float(torch.mean(g)),
            "served_disagree_share": float(torch.mean((g > 0).to(torch.float32))),
            "served_logit_err_mean": float(torch.mean(err))}


def check(st: dict, rec: dict, control: bool = False) -> dict:
    """The numbers held to their limits; with `control`, those of the
    reference one precision step below (float8 activations and digital
    weights, bfloat16 column sums) put in the program's place, read at
    each position of the same prompts and served tokens."""
    sample = _sample(st, rec)
    model, acfg = reference_model(st)
    with torch.no_grad():
        seqs = sequences(sample)
        logits = analog_lm.forward_rows(model, seqs, acfg)
        if control:
            low = analog_lm.forward_rows(model, seqs, acfg, lowp=True)
            return _numbers(gaps(logits, sample, pick=low),
                            logit_errors(logits, top_logits(low, sample), sample))
    return _numbers(gaps(logits, sample),
                    logit_errors(logits, kept_logits(rec, sample), sample))


def attempted(rec: dict) -> int:
    return rec["sent"]

