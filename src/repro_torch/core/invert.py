"""Per-shard in-memory inversion by sort (SPIMI without hash tables), in
PyTorch: the counterpart of the JAX package's ``core/invert.py``.

Entries are laid out in (doc, pos) order, so the reference's 3-key sort
over (term, doc, pos) is one stable sort on the term. Everything is
static-shape: the outputs are N-sized tensors (N = docs x doc_len) with
validity counts, exactly what a flush ships to the host.

Layout produced (entries beyond the counts are zero):
  * doc-granular postings: term, doc-delta, tf per posting (doc-delta:
    the first posting of a term stores doc_id + 1, later ones store
    doc_id - prev_doc_id — always >= 1 for valid postings);
  * position deltas per entry (the first of a posting stores pos + 1);
  * term dictionary: unique terms + CSR offsets into the postings.

The compaction scatters write every non-boundary entry into one trash
slot N, which is sliced off. ``index_put_`` with duplicate indices picks
an arbitrary winner on CUDA; every other target is unique (one posting
rank, one term rank per boundary), so the kept slots are deterministic.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

TERM_PAD = 2 ** 31 - 1  # invalid entries sink to the end of the sort


class InvertedRun(NamedTuple):
    """One in-memory inverted run (pre-flush segment), static shapes."""

    # doc-granular postings (N,)
    postings_term: torch.Tensor
    postings_doc_delta: torch.Tensor
    postings_tf: torch.Tensor
    # position-granular (N,)
    pos_delta: torch.Tensor
    # term dictionary (N,)
    terms_unique: torch.Tensor
    term_start: torch.Tensor  # CSR offsets into postings arrays
    # counts (0-d)
    n_entries: torch.Tensor
    n_postings: torch.Tensor
    n_terms: torch.Tensor
    # per-doc stats (D,)
    doc_len: torch.Tensor


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def _scatter(n: int, tgt: torch.Tensor, vals: torch.Tensor,
             fill: int = 0) -> torch.Tensor:
    """``full(n + 1, fill).at[tgt].set(vals)[:-1]`` — slot n is the trash."""
    out = torch.full((n + 1,), fill, dtype=torch.int32, device=vals.device)
    out[tgt] = vals.to(torch.int32)
    return out[:-1]


def invert_shard(tokens: torch.Tensor, doc_id_base: int) -> InvertedRun:
    """tokens: (D, L) int32 term ids, 0 = padding. doc_id_base: int."""
    D, L = tokens.shape
    dev = tokens.device
    valid2d = tokens > 0
    doc_len = valid2d.sum(dim=1).to(torch.int32)
    term = torch.where(valid2d, tokens.to(torch.int32),
                       TERM_PAD).reshape(D * L)
    doc = (torch.arange(D, dtype=torch.int32, device=dev)[:, None]
           + doc_id_base).expand(D, L).reshape(D * L)
    pos = torch.arange(L, dtype=torch.int32, device=dev)[None, :].expand(
        D, L).reshape(D * L)
    s_term, order = torch.sort(term, stable=True)
    return postings_from_sorted(s_term, doc[order], pos[order], doc_len)


def postings_from_sorted(s_term, s_doc, s_pos, doc_len) -> InvertedRun:
    """Boundary detection + postings extraction over sorted entries."""
    N = s_term.shape[0]
    dev = s_term.device
    valid = s_term != TERM_PAD
    new_term = (s_term != _shift_right(s_term, -1)) & valid
    new_doc = (new_term | (s_doc != _shift_right(s_doc, -1))) & valid

    n_entries = valid.sum().to(torch.int32)
    n_postings = new_doc.sum().to(torch.int32)
    n_terms = new_term.sum().to(torch.int32)

    idx = torch.arange(N, dtype=torch.int32, device=dev)
    ar = torch.arange(N, device=dev)
    posting_rank = torch.cumsum(new_doc, 0) - 1  # posting of entry i
    term_rank = torch.cumsum(new_term, 0) - 1

    # -------- doc-granular postings, compacted by scatter at posting_rank
    tgt = torch.where(new_doc, posting_rank, N)  # N = trash slot
    postings_term = _scatter(N, tgt, s_term)
    prev_doc = _shift_right(s_doc, 0)
    ddelta = torch.where(new_term, s_doc + 1, s_doc - prev_doc)
    postings_doc_delta = _scatter(N, tgt, torch.where(valid, ddelta, 0))

    # tf per posting: difference of consecutive posting start indices
    starts = _scatter(N, tgt, idx)
    starts = torch.where(ar < n_postings, starts, n_entries)
    next_start = torch.cat([starts[1:], n_entries.reshape(1)])
    next_start = torch.where(ar + 1 < n_postings, next_start, n_entries)
    postings_tf = torch.where(ar < n_postings, next_start - starts, 0)

    # -------- position deltas (position-granular stream)
    prev_pos = _shift_right(s_pos, 0)
    pdelta = torch.where(new_doc, s_pos + 1, s_pos - prev_pos)
    pos_delta = torch.where(valid, pdelta, 0)

    # -------- term dictionary
    t_tgt = torch.where(new_term, term_rank, N)
    terms_unique = _scatter(N, t_tgt, s_term)
    term_start = _scatter(N, t_tgt, posting_rank)
    term_start = torch.where(ar < n_terms, term_start, n_postings)

    return InvertedRun(postings_term, postings_doc_delta,
                       postings_tf.to(torch.int32), pos_delta.to(torch.int32),
                       terms_unique, term_start.to(torch.int32),
                       n_entries, n_postings, n_terms, doc_len)


def doc_vectors(tokens: torch.Tensor):
    """Parsed document vectors: per-doc sorted (term, tf) pairs. Returns
    (terms (D, L), tf (D, L), n_uniq (D,)) — rows are per-doc runs padded
    with zeros."""
    D, L = tokens.shape
    dev = tokens.device
    valid = tokens > 0
    term = torch.where(valid, tokens.to(torch.int32), TERM_PAD)
    s_term = torch.sort(term, dim=1).values
    newt = s_term != torch.cat(
        [torch.full((D, 1), -1, dtype=s_term.dtype, device=dev),
         s_term[:, :-1]], dim=1)
    newt &= s_term != TERM_PAD
    n_uniq = newt.sum(dim=1).to(torch.int32)
    rank = torch.cumsum(newt, dim=1) - 1
    tgt = torch.where(newt, rank, L)
    row = torch.arange(D, device=dev)[:, None].expand(D, L)
    out_t = torch.zeros((D, L + 1), dtype=torch.int32, device=dev)
    out_t[row, tgt] = s_term
    out_t = out_t[:, :-1]
    idxs = torch.arange(L, dtype=torch.int32, device=dev).expand(D, L)
    starts = torch.zeros((D, L + 1), dtype=torch.int32, device=dev)
    starts[row, tgt] = idxs
    starts = starts[:, :-1]
    n_valid = (s_term != TERM_PAD).sum(dim=1).to(torch.int32)
    in_range = idxs < n_uniq[:, None]
    starts = torch.where(in_range, starts, n_valid[:, None])
    nxt = torch.cat([starts[:, 1:], n_valid[:, None]], dim=1)
    nxt = torch.where(idxs + 1 < n_uniq[:, None], nxt, n_valid[:, None])
    tf = torch.where(in_range, nxt - starts, 0)
    return out_t, tf.to(torch.int32), n_uniq
