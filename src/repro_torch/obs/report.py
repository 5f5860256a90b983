"""CLI reporter over obs JSONL streams.

  PYTHONPATH=src python -m repro_torch.obs.report run.jsonl [serve.jsonl ...]

A copy of ``repro.obs.report`` (standard library only), with one repair:
a summary record's non-numeric fields (the engine's ``role``) print as
they are, where the reference's ``int()`` raises on them.

Renders, for whatever record kinds the stream contains:

  * step-time breakdown — device-step vs host-fetch spans (the honest
    split train/loop.py emits), loss trajectory, guard-flag counts;
  * guard-event timeline — every skip/rollback/demote/repromote with its
    decoded flag names;
  * per-site FP8 numerics — saturation / underflow-flush max+mean per
    quantize site (the input the ROADMAP's adaptive-precision controller
    will consume);
  * cast-ledger snapshots — activation-cast counts per traced program;
  * serve summary — tick counters, KV-pool occupancy, TTFT/TBT stats;
  * benchmark records — the unified benchmarks/common.py emit() stream.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List


def load_records(paths) -> List[dict]:
    recs = []
    for p in paths:
        with open(p) as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    recs.append(json.loads(line))
                except json.JSONDecodeError as e:
                    print(f"[report] {p}:{ln}: skipping bad record ({e})",
                          file=sys.stderr)
    return recs


def by_kind(recs) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for r in recs:
        out.setdefault(r.get("kind", "?"), []).append(r)
    return out


def _stats(xs):
    if not xs:
        return dict(n=0, mean=0.0, p50=0.0, p95=0.0, max=0.0)
    xs = sorted(xs)
    n = len(xs)
    return dict(n=n, mean=sum(xs) / n, p50=xs[n // 2],
                p95=xs[min(n - 1, int(0.95 * n))], max=xs[-1])


def _fmt_ms(s):
    return (f"n={s['n']:<5d} mean={s['mean']:8.2f}ms p50={s['p50']:8.2f}ms "
            f"p95={s['p95']:8.2f}ms max={s['max']:8.2f}ms")


def _total(v):
    """A summary field as the reporter prints it: numbers as integers,
    anything else (the engine's role) as it is."""
    return int(v) if isinstance(v, (int, float)) else v


def render_steps(steps, out):
    out(f"== train: {len(steps)} steps ==")
    losses = [r["loss"] for r in steps if "loss" in r]
    if losses:
        out(f"  loss: {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"(min {min(losses):.4f})")
    for key, label in (("device_ms", "device step"),
                       ("fetch_ms", "host fetch"),
                       ("total_ms", "total")):
        vals = [r[key] for r in steps if key in r]
        if vals:
            out(f"  {label:<12s} {_fmt_ms(_stats(vals))}")
    dev = sum(r.get("device_ms", 0.0) for r in steps)
    fet = sum(r.get("fetch_ms", 0.0) for r in steps)
    if dev and fet:
        out(f"  host-fetch share of device+fetch: "
            f"{100.0 * fet / (dev + fet):.1f}%")
    flagged = [r for r in steps if r.get("guard_flags")]
    if flagged:
        out(f"  guarded steps flagged: {len(flagged)}/{len(steps)} "
            f"(steps {[r['step'] for r in flagged][:12]}"
            f"{'...' if len(flagged) > 12 else ''})")


def render_sites(steps, out):
    sites: Dict[str, List[tuple]] = {}
    for r in steps:
        for site, pair in (r.get("quant_sites") or {}).items():
            if isinstance(pair, dict):            # {"sat": x, "flush": y}
                pair = (pair.get("sat", 0.0), pair.get("flush", 0.0))
            sites.setdefault(site, []).append(tuple(pair))
    if not sites:
        return
    out("== FP8 numerics: per-quantize-site sat/flush ==")
    out(f"  {'site':<16s} {'sat_max':>9s} {'sat_mean':>9s} "
        f"{'flush_max':>10s} {'flush_mean':>11s}")
    for site in sorted(sites):
        sat = [p[0] for p in sites[site]]
        fl = [p[1] for p in sites[site]]
        out(f"  {site:<16s} {max(sat):9.4f} {sum(sat)/len(sat):9.4f} "
            f"{max(fl):10.4f} {sum(fl)/len(fl):11.4f}")


def render_guard_events(events, out):
    out(f"== guard events: {len(events)} ==")
    for r in events:
        extra = {k: v for k, v in r.items()
                 if k not in ("t", "kind", "step", "event", "flags",
                              "flag_names", "msg")}
        detail = " ".join(f"{k}={v}" for k, v in extra.items())
        out(f"  step {r.get('step', '?'):>6} {r.get('event', '?'):<14s} "
            f"flags={r.get('flag_names', r.get('flags', 0))}"
            f"{(' ' + detail) if detail else ''}")


def render_casts(recs, out):
    out("== cast-ledger snapshots ==")
    for r in recs:
        label = r.get("fn", "?") + (" [demoted]" if r.get("demoted") else "")
        out(f"  [{label}] step={r.get('step')} activation_casts="
            f"{r.get('activation_casts')} fused={r.get('fused_casts')} "
            f"total={r.get('total')}")
        for tag, n in sorted((r.get("by_tag") or {}).items()):
            out(f"      {tag} x{n}")


def render_wire(recs, out):
    out("== DP wire layout ==")
    for r in recs:
        out(f"  buckets={r.get('n_buckets')} wire_rows={r.get('wire_rows')} "
            f"~{r.get('grad_bytes_per_step', 0) / 2**20:.1f} MiB grad "
            f"bytes/step/device (wire={r.get('wire')})")


def render_serve(kinds, out):
    ticks = kinds.get("serve_tick", [])
    done = kinds.get("request_done", [])
    summ = kinds.get("serve_summary", [])
    out(f"== serve: {len(ticks)} ticks, {len(done)} requests ==")
    if ticks:
        occ = [r["kv_used_pages"] for r in ticks if "kv_used_pages" in r]
        dec = [r.get("n_decode", 0) for r in ticks]
        if occ:
            out(f"  kv pages used: mean {sum(occ)/len(occ):.1f} "
                f"max {max(occ)}")
        out(f"  decode batch: mean {sum(dec)/len(dec):.1f} max "
            f"{max(dec) if dec else 0}")
    if done:
        ttft = [r["ttft_ms"] for r in done if "ttft_ms" in r]
        tbt = [r["tbt_ms_mean"] for r in done if r.get("tbt_ms_mean")
               is not None]
        if ttft:
            out(f"  TTFT        {_fmt_ms(_stats(ttft))}")
        if tbt:
            out(f"  TBT (mean)  {_fmt_ms(_stats(tbt))}")
        ev = sum(r.get("n_evictions", 0) for r in done)
        if ev:
            out(f"  evictions across finished requests: {ev}")
        cached = sum(r.get("cached_tokens", 0) for r in done)
        if cached:
            out(f"  prompt tokens served from prefix cache: {cached}")
    for r in summ:
        c = {k: v for k, v in r.items() if k not in ("t", "kind")}
        out("  totals: " + " ".join(f"{k}={_total(v)}"
                                    for k, v in sorted(c.items())))
    hits = kinds.get("prefix_hit", [])
    if hits:
        toks = [r.get("cached_tokens", 0) for r in hits]
        cow = sum(1 for r in hits if r.get("cow"))
        out(f"  prefix cache: {len(hits)} hit admissions, "
            f"{sum(toks)} cached tokens "
            f"(max {max(toks)}/request, {cow} copy-on-write)")
    routes = kinds.get("route", [])
    if routes:
        per: Dict[int, List[dict]] = {}
        for r in routes:
            per.setdefault(r.get("replica", -1), []).append(r)
        out(f"  router: {len(routes)} decisions over {len(per)} replicas")
        for idx in sorted(per):
            ov = [r.get("overlap", 0.0) for r in per[idx]]
            ld = [r.get("load", 0.0) for r in per[idx]]
            out(f"    replica {idx}: {len(per[idx])} requests  "
                f"mean_overlap={sum(ov)/len(ov):.2f}  "
                f"mean_load={sum(ld)/len(ld):.2f}")
    for r in kinds.get("router_summary", []):
        c = {k: v for k, v in r.items() if k not in ("t", "kind")}
        out("  fleet totals: " + " ".join(f"{k}={_total(v)}"
                                          for k, v in sorted(c.items())))


def render_disagg(kinds, out):
    migs = kinds.get("migration", [])
    summ = kinds.get("disagg_summary", [])
    out(f"== disaggregation: {len(migs)} KV migrations ==")
    if migs:
        bts = [r.get("bytes", 0) for r in migs]
        out(f"  wire: {sum(bts) / 2**20:.2f} MiB total, "
            f"mean {sum(bts)/len(bts)/2**10:.1f} KiB/migration")
        shipped = sum(r.get("shipped_pages", 0) for r in migs)
        dedup = sum(r.get("deduped_pages", 0) for r in migs)
        if shipped + dedup:
            out(f"  pages: {shipped} shipped, {dedup} deduped against "
                f"receiver caches "
                f"({100.0 * dedup / (shipped + dedup):.1f}% not re-sent)")
        q = [r["queue_ms"] for r in migs if "queue_ms" in r]
        if q:
            out(f"  handoff queue {_fmt_ms(_stats(q))}")
        ms = [r["ms"] for r in migs if "ms" in r]
        if ms:
            out(f"  migration    {_fmt_ms(_stats(ms))}")
        # per-tier placement: who donated, who received
        for key, label in (("donor", "prefill tier"),
                           ("receiver", "decode tier")):
            per: Dict[int, int] = {}
            for r in migs:
                per[r.get(key, -1)] = per.get(r.get(key, -1), 0) + 1
            parts = " ".join(f"r{idx}:{n}" for idx, n in sorted(per.items()))
            out(f"  {label:<13s} {parts}")
    for r in summ:
        budget = r.get("transfer_budget_bytes", 0)
        n_mig = max(r.get("migrations", 0), 1)
        util = (r.get("kv_transfer_bytes", 0) / n_mig / budget) if budget \
            else 0.0
        out("  totals: " + " ".join(
            f"{k}={_total(v)}" for k, v in sorted(r.items())
            if k not in ("t", "kind")))
        out(f"  transfer budget: {budget / 2**20:.2f} MiB/cycle, mean "
            f"utilization {100.0 * util:.1f}%/migration, "
            f"{r.get('budget_deferrals', 0)} deferrals")


def render_bench(recs, out):
    out(f"== benchmark records: {len(recs)} ==")
    out(f"  {'name':<36s} {'value':>14s} {'units':<8s} {'source':<9s} "
        f"derived")
    for r in recs:
        out(f"  {str(r.get('name')):<36s} {r.get('value', 0):>14.2f} "
            f"{str(r.get('units', '')):<8s} {str(r.get('source', '')):<9s} "
            f"{r.get('derived', '')}")


def render(recs, out=print) -> int:
    """Render every known section; returns the number of records used."""
    kinds = by_kind(recs)
    steps = kinds.get("step", [])
    if steps:
        render_steps(steps, out)
        render_sites(steps, out)
    if "guard" in kinds:
        render_guard_events(kinds["guard"], out)
    if "cast_ledger" in kinds:
        render_casts(kinds["cast_ledger"], out)
    if "wire_layout" in kinds:
        render_wire(kinds["wire_layout"], out)
    if any(k in kinds for k in ("serve_tick", "request_done",
                                "serve_summary", "prefix_hit", "route",
                                "router_summary")):
        render_serve(kinds, out)
    if any(k in kinds for k in ("migration", "disagg_summary")):
        render_disagg(kinds, out)
    if "bench" in kinds:
        render_bench(kinds["bench"], out)
    other = [k for k in kinds if k not in
             ("step", "guard", "cast_ledger", "wire_layout", "serve_tick",
              "request_done", "serve_summary", "prefix_hit", "route",
              "router_summary", "migration", "disagg_summary", "bench",
              "registry")]
    if other:
        out("== other records ==")
        for k in sorted(other):
            out(f"  {k}: {len(kinds[k])}")
    return len(recs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", help="obs JSONL file(s)")
    args = ap.parse_args(argv)
    recs = load_records(args.paths)
    if not recs:
        print("[report] no records found", file=sys.stderr)
        return 1
    try:
        n = render(recs)
        print(f"[report] {n} records from {len(args.paths)} file(s)")
    except BrokenPipeError:        # e.g. piped into `head`
        sys.stderr.close()
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
