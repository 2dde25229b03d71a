"""Carry state of the JAX package over to the port, so both compute on
identical state: a ``repro`` ``Segment`` becomes a ``repro_torch``
``Segment``, and a ``repro`` ``BlockMaxIndex`` (fixed-stride layout, with
its packed planes) becomes the port's.

The inputs are duck-typed: anything with the right attributes, whose
arrays convert with ``numpy.asarray``. Nothing of the JAX package is
imported here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.query import BlockMaxIndex
from repro_torch.core.segments import Segment, fresh_seg_id

_SEG_ARRAYS = ("terms", "term_start", "docs", "tf", "positions", "pos_start",
               "doc_ids", "doc_len")


def segment_from_repro(seg, base_ids: dict = None) -> Segment:
    """A port ``Segment`` with copies of ``seg``'s arrays, its merge tier,
    tombstones and BP ``reorder``. Segment ids are the port's own; pass
    one ``base_ids`` dict across a set of segments so two segments that
    share a postings core in ``repro`` share one in the port too."""
    kw = {n: np.array(getattr(seg, n)) for n in _SEG_ARRAYS}
    for n in ("deletes", "reorder"):
        v = getattr(seg, n, None)
        kw[n] = None if v is None else np.array(v)
    sid = fresh_seg_id()
    base = sid
    if base_ids is not None:
        base = base_ids.setdefault(getattr(seg, "base_id", id(seg)), sid)
    return Segment(generation=int(getattr(seg, "generation", 0)),
                   seg_id=sid, base_id=base, **kw)


def _words(a, device) -> torch.Tensor:
    """uint32 words -> the port's int32 bit-pattern tensor."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def _arr(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(np.asarray(a), dtype)).to(device)


def block_index_from_repro(index, device="cpu") -> BlockMaxIndex:
    """The port's ``BlockMaxIndex`` over the same packed planes, bit widths,
    block metadata and statistics as ``index`` (a ``repro`` fixed-stride
    ``BlockMaxIndex``)."""
    if getattr(index, "packed_docs", None) is None:
        raise NotImplementedError(
            "the compact layout is not ported yet (ROADMAP.md, Queue 2)")
    device = torch.device(device)
    return BlockMaxIndex(
        terms=_arr(index.terms, np.int32, device),
        term_block_start=_arr(index.term_block_start, np.int32, device),
        idf=_arr(index.idf, np.float32, device),
        packed_docs=_words(index.packed_docs, device),
        bw_docs=_arr(index.bw_docs, np.int32, device),
        packed_tf=_words(index.packed_tf, device),
        bw_tf=_arr(index.bw_tf, np.int32, device),
        first_doc=_arr(index.first_doc, np.int32, device),
        max_tf=_arr(index.max_tf, np.float32, device),
        doc_norm=_arr(index.doc_norm, np.float32, device),
        n_docs=int(index.n_docs),
        max_blocks_per_term=int(index.max_blocks_per_term),
        k1=float(index.k1), b=float(index.b),
        min_dl=(None if index.min_dl is None
                else _arr(index.min_dl, np.float32, device)),
        avgdl=float(index.avgdl),
        last_doc=(None if index.last_doc is None
                  else _arr(index.last_doc, np.int32, device)))
