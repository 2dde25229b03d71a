"""Doc-sharded -> term-sharded all-to-all, the distributed merge stage, in
PyTorch: the counterpart of the JAX package's ``core/shuffle.py``.

After every rank inverts its own documents (coordination-free, the
paper's design), postings entries go to the rank that owns their term
(``term % n_dest``) in a capacity-padded all-to-all over the ``model``
axis. Each ``data`` row keeps its own document partition, so afterwards
rank (d, m) holds term shard m of partition d; the cross-partition merge
happens at flush, on the host, as Lucene's segment merges do.

One rank's exchange is three stages, so that the collective stands
alone between two pure functions:

  * ``route_send`` (``shuffle_send`` for a rank's tokens): stable sort
    by destination, rank within the destination, scatter into
    ``(n_dest, capacity)`` buffers (entries past a destination's
    capacity are dropped and counted);
  * ``Mesh.all_to_all`` over the axis (``distributed/mesh.py``);
  * ``route_receive`` (``shuffle_receive``): decode the received rows,
    sort them back into (term, doc, pos) order, count what arrived.

``payload="packed2"`` ships two words an entry instead of three: the
term and ``(local_doc << 16) | pos`` as a uint32 bit pattern (held in
int32), the receiver adding each source row's doc base back. It needs
local doc indices and positions below 65536. Words are computed in int64
and wrapped to 32 bits, and read back with a logical shift, since
int32's ``>>`` is arithmetic and a local doc >= 32768 sets the sign bit.

The JAX package sorts with ``lax.sort``; here ``num_keys=1, is_stable``
is ``torch.sort(stable=True)`` plus gathers, and the final 3-key sort is
two stable passes, least significant first: (doc, pos) as one int64 key,
then the term. Bit for bit the JAX functions' outputs, for either
payload and either sort of the inversion (``tests/test_torch_shuffle.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.invert import (TERM_PAD, InvertedRun,
                                     postings_from_sorted)

PAYLOADS = ("raw", "packed2")
_MASK32 = 0xFFFFFFFF


class ShuffleStats(NamedTuple):
    sent: torch.Tensor      # valid entries sent (0-d int32)
    dropped: torch.Tensor   # entries beyond per-destination capacity
    recv: torch.Tensor      # valid entries received


class ShuffleSend(NamedTuple):
    """One rank's send stage: the buffers for the all-to-all and what the
    receive stage needs besides them."""

    buffers: tuple          # (n_dest, capacity) int32 each: term, doc, pos
    #                         (raw) or term, word (packed2); row r is for
    #                         the rank at index r along the axis
    sent: torch.Tensor
    dropped: torch.Tensor
    doc_len: torch.Tensor   # (D,) the rank's own docs' lengths
    doc_base: int
    docs_per_dev: int
    payload: str


def shuffle_capacity(D: int, L: int, n_dest: int,
                     capacity_factor: float = 1.35) -> int:
    """Entries per destination: the JAX package's float arithmetic, then
    rounded up to a multiple of 128 (at least 128)."""
    capacity = int(D * L * capacity_factor / n_dest)
    return max((capacity + 127) // 128 * 128, 128)


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    x = x & _MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _check_payload(payload: str) -> None:
    if payload not in PAYLOADS:
        raise ValueError(f"payload {payload!r}: use one of {PAYLOADS}")


def route_send(s_term, s_doc, s_pos, *, n_dest: int, capacity: int,
               payload: str = "raw", doc_base: int = None):
    """The send stage of ``route_entries`` over sorted (term, doc, pos)
    entries. Returns (buffers, sent, dropped): ``buffers`` as in
    ``ShuffleSend``; padding slots hold ``TERM_PAD`` and zeros."""
    _check_payload(payload)
    N = s_term.shape[0]
    dev = s_term.device
    s_term = s_term.to(torch.int32)
    valid = s_term != TERM_PAD
    dest = torch.where(valid, s_term % n_dest, n_dest).to(torch.int32)
    # a stable sort by destination keeps (term, doc, pos) order within one
    d_s, order = torch.sort(dest, stable=True)
    t_s, do_s, p_s = s_term[order], s_doc[order], s_pos[order]
    starts = torch.searchsorted(
        d_s, torch.arange(n_dest, dtype=torch.int32, device=dev))
    rank = torch.arange(N, device=dev) - starts[d_s.clamp(0, n_dest - 1)]
    keep = (rank < capacity) & (d_s < n_dest)
    slot = torch.where(keep, d_s.to(torch.int64) * capacity + rank,
                       n_dest * capacity)

    def scatter(vals, fill):
        buf = torch.full((n_dest * capacity + 1,), fill, dtype=torch.int32,
                         device=dev)
        buf[slot] = vals.to(torch.int32)     # slot n_dest * capacity: trash
        return buf[:-1].reshape(n_dest, capacity)

    if payload == "packed2":
        if doc_base is None:
            raise ValueError("payload 'packed2' needs doc_base")
        local = (do_s.to(torch.int64) - doc_base) & _MASK32
        word = ((local << 16) & _MASK32) | (p_s.to(torch.int64) & _MASK32)
        buffers = (scatter(t_s, TERM_PAD), scatter(_wrap_i32(word), 0))
    else:
        buffers = (scatter(t_s, TERM_PAD), scatter(do_s, 0),
                   scatter(p_s, 0))
    sent = valid.sum().to(torch.int32)
    dropped = ((~keep) & (d_s < n_dest)).sum().to(torch.int32)
    return buffers, sent, dropped


def route_receive(received, *, payload: str = "raw", axis_index: int = 0,
                  doc_base: int = None, docs_per_dev: int = 0):
    """The receive stage of ``route_entries``: ``received`` holds the
    buffers the all-to-all returned (row r from the source at index r
    along the axis). Returns ((term, doc, pos) sorted, each of
    n_dest * capacity entries, received valid-entry count)."""
    _check_payload(payload)
    if payload == "packed2":
        rt, rw = received
        n_dest = rt.shape[0]
        # row r came from the source at index r of this mesh line; the
        # bases along the shuffle axis step by docs_per_dev
        row_base = doc_base - axis_index * docs_per_dev
        src = torch.arange(n_dest, dtype=torch.int64, device=rt.device)
        base_of_src = (row_base + src * docs_per_dev)[:, None]
        w = rw.to(torch.int64) & _MASK32
        rd = _wrap_i32((w >> 16) + base_of_src)
        rp = (w & 0xFFFF).to(torch.int32)
        rd = torch.where(rt == TERM_PAD, 0, rd)
    else:
        rt, rd, rp = received
    rt, rd, rp = rt.reshape(-1), rd.reshape(-1), rp.reshape(-1)
    # the 3-key sort: (doc, pos) as one int64 key, then the term
    dp = rd.to(torch.int64) * 2 ** 32 + (rp.to(torch.int64) + 2 ** 31)
    o1 = torch.sort(dp, stable=True).indices
    rt, rd, rp = rt[o1], rd[o1], rp[o1]
    rt, o2 = torch.sort(rt, stable=True)
    rd, rp = rd[o2], rp[o2]
    return (rt, rd, rp), (rt != TERM_PAD).sum().to(torch.int32)


def route_entries(s_term, s_doc, s_pos, *, mesh, axis_name: str,
                  capacity: int, payload: str = "raw", doc_base: int = None,
                  docs_per_dev: int = 0):
    """Route sorted (term, doc, pos) entries to their term's owner over
    ``axis_name`` of ``mesh`` (a ``distributed.Mesh``); ``n_dest`` is the
    axis size. Returns re-sorted local (term, doc, pos) of
    n_dest * capacity entries, and ``ShuffleStats``."""
    buffers, sent, dropped = route_send(
        s_term, s_doc, s_pos, n_dest=mesh.axis_size(axis_name),
        capacity=capacity, payload=payload, doc_base=doc_base)
    received = tuple(mesh.all_to_all(b, axis_name) for b in buffers)
    out, recv = route_receive(received, payload=payload,
                              axis_index=mesh.axis_index(axis_name),
                              doc_base=doc_base, docs_per_dev=docs_per_dev)
    return out, ShuffleStats(sent, dropped, recv)


def shuffle_send(tokens: torch.Tensor, doc_id_base: int, *, n_dest: int,
                 capacity_factor: float = 1.35, payload: str = "raw",
                 single_key_sort: bool = False) -> ShuffleSend:
    """Sort-invert a rank's docs ``tokens`` (D, L) (0 = padding) and fill
    the send buffers. ``single_key_sort``: the (doc, pos) pairs come in
    row-major order, so a stable sort on the term alone gives the 3-key
    sort's order; both are kept, as in the JAX package."""
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
    if single_key_sort:
        s_term, order = torch.sort(term, stable=True)
        s_doc, s_pos = doc[order], pos[order]
    else:
        o1 = torch.sort(doc.to(torch.int64) * 2 ** 32 + pos,
                        stable=True).indices
        s_term, o2 = torch.sort(term[o1], stable=True)
        s_doc, s_pos = doc[o1][o2], pos[o1][o2]
    capacity = shuffle_capacity(D, L, n_dest, capacity_factor)
    buffers, sent, dropped = route_send(
        s_term, s_doc, s_pos, n_dest=n_dest, capacity=capacity,
        payload=payload, doc_base=doc_id_base)
    return ShuffleSend(buffers, sent, dropped, doc_len, int(doc_id_base), D,
                       payload)


def shuffle_receive(sent: ShuffleSend, received,
                    axis_index: int) -> tuple:
    """The term-sharded postings of what arrived: (``InvertedRun``,
    ``ShuffleStats``)."""
    (rt, rd, rp), recv = route_receive(
        received, payload=sent.payload, axis_index=axis_index,
        doc_base=sent.doc_base, docs_per_dev=sent.docs_per_dev)
    run: InvertedRun = postings_from_sorted(rt, rd, rp, sent.doc_len)
    return run, ShuffleStats(sent.sent, sent.dropped, recv)


def invert_and_shuffle(tokens: torch.Tensor, doc_id_base: int, *, mesh,
                       axis_name: str = "model",
                       capacity_factor: float = 1.35, payload: str = "raw",
                       single_key_sort: bool = False) -> tuple:
    """One rank: sort-invert its docs, shuffle the entries to their term
    owners over ``axis_name``, build the term-sharded postings. Returns
    (``InvertedRun``, ``ShuffleStats``)."""
    sent = shuffle_send(tokens, doc_id_base,
                        n_dest=mesh.axis_size(axis_name),
                        capacity_factor=capacity_factor, payload=payload,
                        single_key_sort=single_key_sort)
    received = tuple(mesh.all_to_all(b, axis_name) for b in sent.buffers)
    return shuffle_receive(sent, received, mesh.axis_index(axis_name))
