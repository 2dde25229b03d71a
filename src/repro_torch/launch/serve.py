"""Serving entry point of the port, in two modes.

Retrieval (the default): index, refresh, serve BM25 top-k through the
fixed-slot ``QueryScheduler``, keep indexing, refresh and serve again,
then delete and update served docs, refresh and serve once more —
asserting that no tombstoned doc surfaces. ``--refresh-every S`` runs the
indexer's NRT refresh daemon at that period, and the phase after the
deletes serves the daemon's snapshot instead of a manual refresh.

LM (``--mode lm``): batched prefill of ``--requests`` random prompts of
``--prompt-len`` tokens, then ``--gen`` greedy tokens decoded over the KV
cache (``generate``), on seeded random weights of ``--arch`` (the JAX
launcher's LM mode; the port keeps retrieval as its default mode).

  python -m repro_torch.launch.serve                       # smoke, on CUDA
  python -m repro_torch.launch.serve --device cpu          # plain PyTorch
  python -m repro_torch.launch.serve --device cpu --index-dir DIR
  python -m repro_torch.launch.serve --device cpu --refresh-every 0.05
  python -m repro_torch.launch.serve --config full --docs 1048576 \\
      --batch-docs 16384 --requests 1024
  python -m repro_torch.launch.serve --mode lm --device cpu   # gemma2 smoke
  python -m repro_torch.launch.serve --mode lm --config full \\
      --prompt-len 8192 --gen 16                # gemma2-9b at full width
  python -m repro_torch.launch.serve --mode lm --device cpu \\
      --arch moonshot-v1-16b-a3b                # the MoE LM, SMOKE
  python -m repro_torch.launch.serve --mode lm --config full \\
      --arch moonshot-v1-16b-a3b --param-dtype bfloat16 --prompt-len 4096

In retrieval mode, ``--config smoke`` is the SMOKE pipeline over the
TINY corpus (the JAX
package's ``launch/serve.py --mode retrieval``); ``--config full`` is the
full ``lucene_envelope`` CONFIG over a corpus with ClueWeb09b's law
(``CW09B_SMALL``) scaled to ``--docs``. The pruned phases without
tombstones serve through the midgrid kernel; the phase after the deletes
takes the plain BM25 kernel (the midgrid gate needs a tombstone-free
segment).

``--index-dir DIR`` makes the index durable (an ``FSDirectory``): the
first half is committed and the first phase serves the searcher
recovered from those bytes (``open_searcher``); after the deletes and
updates a second commit is recovered and must serve the indexer's live
doc count. An existing index in DIR is resumed at its last commit.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.configs import lucene_envelope
from repro_torch.configs.registry import get_arch
from repro_torch.core.indexer import Indexer
from repro_torch.core.searcher import ReaderCache
from repro_torch.data.corpus import CW09B_SMALL, TINY, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import transformer as TF
from repro_torch.serving.query_scheduler import QueryRequest, QueryScheduler
from repro_torch.storage import FSDirectory, open_searcher


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(sched, reqs, device):
    """Serve ``reqs`` one scheduler batch at a time; returns the finished
    requests and each batch's wall time (submit to results on the host)."""
    done, lat = [], []
    for s in range(0, len(reqs), sched.slots):
        chunk = reqs[s:s + sched.slots]
        t0 = time.perf_counter()
        for r in chunk:
            r.done = False
            sched.submit(r, now=t0)
        done += sched.run_to_completion()
        _sync(device)
        lat.append(time.perf_counter() - t0)
    return done, lat


def generate_batches(corpus, n_batches: int, batch_docs: int,
                     workers: int = 8) -> list:
    """Every corpus batch, made up front on a few threads (numpy releases
    the GIL in its bulk draws). This is set-up: it is timed apart from
    indexing."""
    with ThreadPoolExecutor(max(1, min(workers, n_batches))) as pool:
        return list(pool.map(lambda i: corpus.batch(i, batch_docs),
                             range(n_batches)))


def generate(cfg, params, prompts, gen_tokens: int, mesh=None,
             stats: dict = None):
    """prompts: (B, S) token ids, right-padded with 0; returns (B, gen)
    greedy tokens. Prefill runs over the whole padded batch and takes its
    logits at position S - 1; decode then appends at each row's own length
    ``(prompts > 0).sum(1)``, as the JAX launcher's ``generate`` does.
    ``stats``, if given, receives ``prefill_s`` and ``decode_s`` (wall
    time, synchronized on the device) and ``decode_steps``."""
    device = prompts.device
    B, S = prompts.shape
    t0 = time.perf_counter()
    caches, logits = TF.prefill(params, prompts, cfg, pad_to=S + gen_tokens,
                                mesh=mesh)
    lengths = (prompts > 0).sum(dim=1)
    out = [torch.argmax(logits, dim=-1)]
    _sync(device)
    t1 = time.perf_counter()
    for i in range(gen_tokens - 1):
        caches, logits = TF.decode_step(params, caches, lengths + i, out[-1],
                                        cfg, mesh=mesh)
        out.append(torch.argmax(logits, dim=-1))
    toks = torch.stack(out, dim=1)
    _sync(device)
    if stats is not None:
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     decode_steps=gen_tokens - 1)
    return toks


def serve_lm(args):
    """Greedy generation for ``--requests`` random prompts on random
    weights, both drawn from seed 0 (the JAX launcher's fixed
    ``PRNGKey(0)``). ``--param-dtype`` replaces the config's
    ``param_dtype``. Returns a dict: cfg, params, tokens and report (with
    the weights' dtype and, on CUDA, the peak device memory)."""
    device = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.smoke if args.config == "smoke" else entry.config
    if args.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.param_dtype)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    params = TF.init_params(cfg, gen)
    _sync(device)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (args.requests, args.prompt_len))).to(device)
    stats = {}
    toks = generate(cfg, params, prompts, args.gen, stats=stats)
    dt = stats["prefill_s"] + stats["decode_s"]
    peak_gb = (torch.cuda.max_memory_allocated(device) / 1e9
               if device.type == "cuda" else None)
    report = dict(arch=cfg.name, device=str(device), init_s=init_s,
                  param_dtype=cfg.param_dtype, peak_gb=peak_gb,
                  requests=args.requests, prompt_len=args.prompt_len,
                  gen=args.gen, tok_per_s=args.requests * args.gen / dt,
                  decode_ms_per_step=(stats["decode_s"] * 1e3
                                      / max(stats["decode_steps"], 1)),
                  **stats)
    print(f"arch={cfg.name} served {args.requests} requests x "
          f"{args.gen} tokens ({args.prompt_len}-token prompts) in "
          f"{dt:.2f}s ({report['tok_per_s']:.1f} tok/s; prefill "
          f"{stats['prefill_s']:.3f}s, decode "
          f"{report['decode_ms_per_step']:.2f} ms/step; {cfg.param_dtype} "
          f"weights, peak device memory "
          f"{'not measured' if peak_gb is None else f'{peak_gb:.2f} GB'})")
    print("sample generations:", toks[:2, :8].cpu().numpy())
    return dict(cfg=cfg, params=params, tokens=toks, report=report)


def serve_retrieval(args):
    """BM25 serving over live segments via the fixed-slot QueryScheduler.
    Returns ``(phases, report)``: per serving phase ("first", "refreshed",
    "lifecycle") the searcher it served from and its finished requests,
    and a dict of the run's measurements."""
    device = resolve_device(args.device)
    if args.config == "smoke":
        cfg, spec = lucene_envelope.SMOKE, TINY
    else:
        cfg = lucene_envelope.CONFIG
        spec = dataclasses.replace(CW09B_SMALL, n_docs=args.docs)
    corpus = SyntheticCorpus(spec, doc_buffer_len=cfg.doc_len)
    n_batches = max(args.docs // args.batch_docs, 2)
    half = n_batches // 2
    target_dir = FSDirectory(args.index_dir) if args.index_dir else None
    ix = Indexer(cfg=cfg, device=device, target_dir=target_dir,
                 refresh_every=args.refresh_every)
    recovered_docs = sum(s.live_doc_count
                         for s in ix.merger.live_segments())
    report = {"device": str(device), "docs": n_batches * args.batch_docs}
    t0 = time.perf_counter()
    batches = generate_batches(corpus, n_batches, args.batch_docs)
    report["generate_s"] = time.perf_counter() - t0

    # index_s: corpus batches through index_batch (flushes included);
    # refresh*_s: the refreshes that make them searchable (the final
    # flush + reader builds, synchronized on the device)
    t0 = time.perf_counter()
    for i in range(half):
        ix.index_batch(batches[i])
    report["index_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if target_dir is not None:
        gen = ix.commit()
        report["commit1_s"] = time.perf_counter() - t0
        # serve what recovery reads back from the committed bytes, not
        # the in-memory segments
        gen_r, searcher = open_searcher(target_dir,
                                        ReaderCache(device=device))
        assert gen_r == gen, (gen_r, gen)
        print(f"durable index: commit gen {gen} "
              f"({recovered_docs} docs recovered at startup); serving "
              f"{searcher.n_docs} docs recovered from {args.index_dir}")
    else:
        searcher = ix.refresh()
    _sync(device)
    report["refresh1_s"] = time.perf_counter() - t0
    sched = QueryScheduler(searcher=searcher, slots=args.slots,
                           max_terms=args.query_terms, k=args.topk,
                           device=device)

    rng = np.random.default_rng(0)
    vocab = np.unique(batches[0][:32])[1:]

    def make_reqs(n, rid0=0):
        return [QueryRequest(rid=rid0 + i, terms=rng.choice(
                    vocab, size=args.query_terms, replace=False),
                    k=args.topk)
                for i in range(n)]

    # warm up on throwaway queries so the timed section is steady-state
    warm = make_reqs(args.slots, rid0=-args.slots)
    for r in warm:
        sched.submit(r)
    sched.step()
    reqs = make_reqs(args.requests)
    t0 = time.perf_counter()
    done1, lat1 = _serve(sched, reqs, device)
    dt = max(time.perf_counter() - t0, 1e-9)
    report.update(serve1_queries=len(done1), serve1_s=dt,
                  qps=len(done1) / dt,
                  batch_p50_ms=float(np.percentile(lat1, 50)) * 1e3,
                  batch_p99_ms=float(np.percentile(lat1, 99)) * 1e3,
                  segments1=searcher.n_segments)
    print(f"retrieval: {searcher.n_segments} live segments, "
          f"{searcher.n_docs} docs; served {len(done1)} queries "
          f"in {dt*1000:.0f}ms ({len(done1)/dt:.0f} qps)")
    ps = sched.prune_stats
    print(f"pruning: {ps.blocks_candidate} candidate blocks -> "
          f"{ps.blocks_survived} survived -> {ps.blocks_scored} scored "
          f"(skip rate {ps.skip_rate:.2f}, "
          f"{ps.segments_skipped} segments skipped)")
    print(f"midgrid: {ps.blocks_skipped_midgrid} survivor blocks skipped "
          f"inside the kernel grid")

    # keep indexing, refresh, serve again — search-while-indexing
    t0 = time.perf_counter()
    for i in range(half, n_batches):
        ix.index_batch(batches[i])
    t1 = time.perf_counter()
    sched.swap_searcher(ix.refresh())
    report["index_s"] += t1 - t0
    report["refresh2_s"] = time.perf_counter() - t1
    report["docs_per_s"] = report["docs"] / (
        report["index_s"] + report["refresh1_s"] + report["refresh2_s"])
    print(f"refresh: {ix.stats.last_refresh_s*1000:.1f}ms, "
          f"reader builds {ix.reader_cache.builds} "
          f"(cache hits {ix.reader_cache.hits})")
    done2, _ = _serve(sched, reqs[:args.slots], device)
    top = f"top score {float(done2[0].scores[0]):.3f}" if done2 \
        else "no queries"
    print(f"post-refresh: {sched.searcher.n_docs} docs searchable; {top}")
    phases = {"first": (searcher, done1),
              "refreshed": (sched.searcher, done2)}

    # --- document lifecycle: delete + update live docs, serve again ------
    if args.deletes or args.updates:
        served = np.unique(np.concatenate(
            [r.doc_ids for r in done2 if r.doc_ids is not None]))
        served = served[served >= 0]
        del_ids = served[:args.deletes]
        upd_ids = served[args.deletes:args.deletes + args.updates]
        ix.delete(del_ids)
        for d in upd_ids:
            d = int(d)
            ix.update(d, batches[d % n_batches][d % args.batch_docs])
        t0 = time.perf_counter()
        if args.refresh_every:
            # the daemon folds the deletes in and swaps ix.searcher: wait
            # for two ticks, since one in flight when r0 is read may
            # predate the acks, but the next one started after them
            r0 = ix.stats.refreshes
            deadline = time.time() + max(40 * args.refresh_every, 10.0)
            while ix.stats.refreshes < r0 + 2 and time.time() < deadline:
                time.sleep(args.refresh_every / 4)
            sched.swap_searcher(ix.searcher)
        else:
            sched.swap_searcher(ix.refresh())
        report["refresh3_s"] = time.perf_counter() - t0
        done3, _ = _serve(sched, reqs[:args.slots], device)
        got = np.concatenate([r.doc_ids for r in done3]) if done3 \
            else np.zeros(0, np.int64)
        gone = set(del_ids.tolist()) | set(upd_ids.tolist())
        assert not (set(got[got >= 0].tolist()) & gone), \
            "a tombstoned doc surfaced after its delete was acknowledged"
        rep = ix.envelope_report()
        print(f"lifecycle: deleted {len(del_ids)} + updated {len(upd_ids)} "
              f"docs; {sched.searcher.n_docs} live "
              f"({rep['deleted_docs']} tombstoned awaiting merge); "
              f"no deleted doc served")
        phases["lifecycle"] = (sched.searcher, done3)
        report.update(deleted=len(del_ids), updated=len(upd_ids))
        if target_dir is not None:
            gen = ix.commit()
            _, s_rec = open_searcher(FSDirectory(args.index_dir),
                                     ReaderCache(device=device))
            n_live = sum(s.live_doc_count
                         for s in ix.merger.live_segments())
            assert s_rec.n_docs == n_live, (s_rec.n_docs, n_live)
            livs = [f for f in FSDirectory(args.index_dir).list_files()
                    if f.endswith(".liv")]
            print(f"lifecycle durable: commit gen {gen}, "
                  f"{len(livs)} .liv delete generation(s), recovery "
                  f"serves {s_rec.n_docs} live docs")
    snap = ix.merger.snapshot()
    report.update(flush_wall_s=ix.stats.wall_s,
                  merge_wall_s=snap["merge_wall_s"],
                  n_merges=snap["n_merges"],
                  segments=sched.searcher.n_segments,
                  prune_stats=dataclasses.asdict(sched.prune_stats))
    ix.close()
    return phases, report


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("retrieval", "lm"),
                    default="retrieval")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a CUDA device) or "
                         "cpu for the plain PyTorch path")
    ap.add_argument("--config", choices=("smoke", "full"), default="smoke",
                    help="smoke: the reduced config; full: the published "
                         "widths (lucene_envelope CONFIG, or --arch's)")
    ap.add_argument("--arch", default="gemma2-9b",
                    help="lm mode: the architecture (configs/registry.py)")
    ap.add_argument("--param-dtype", default=None,
                    choices=("float32", "bfloat16"),
                    help="lm mode: the weights' dtype (default: the "
                         "config's param_dtype)")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="lm mode: tokens per prompt")
    ap.add_argument("--gen", type=int, default=16,
                    help="lm mode: tokens generated per request")
    ap.add_argument("--docs", type=int, default=256,
                    help="docs to index (two halves, refresh between)")
    ap.add_argument("--batch-docs", type=int, default=32)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--query-terms", type=int, default=4)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--deletes", type=int, default=8,
                    help="tombstone this many served docs and prove the "
                         "next snapshot never returns them")
    ap.add_argument("--updates", type=int, default=4,
                    help="replace this many served docs (delete + re-add)")
    ap.add_argument("--refresh-every", type=float, default=0.0,
                    help="run the NRT refresh daemon at this period (s); "
                         "the phase after the deletes serves its snapshot")
    ap.add_argument("--index-dir", default=None,
                    help="durable FSDirectory index: commit, recover from "
                         "disk, then serve (resumes an existing index at "
                         "its last commit point)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mode == "lm":
        return serve_lm(args)
    return serve_retrieval(args)


if __name__ == "__main__":
    main()
