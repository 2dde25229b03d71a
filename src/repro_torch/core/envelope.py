"""The performance-envelope model (the paper's contribution, §3-§4);
the port's copy of the JAX package's ``core/envelope.py``. Its
outputs are the model's, in the paper's media units, never a
measurement of the card.

Inverted indexing is a three-stage pipe:
  source read  ->  in-memory inversion (all cores)  ->  target write
with stage times
  T_read  = G / read_bw(source)
  T_cpu   = G * c_idx  +  G * c_src_fs  +  I * alpha * c_tgt_fs
  T_write = I * alpha / write_bw(target)
where G = raw collection bytes, I = final index bytes (paper reports both),
and alpha = merge write amplification (every flush + every hierarchical
merge rewrite; repro_torch.core.merge *measures* alpha for our own pipeline).

Overlapped pipeline: T = max(stages); when source and target share a
controller/medium (paper: SSD->SSD), reads and writes serialize:
T_io = (G + I*alpha) / bw * interference, and T = max(T_io, T_cpu).

File-system CPU taxes model the paper's ZFS finding (Merkle-tree
checksumming costs CPU on both the read and write paths).

``calibrate()`` fits the interpretable constants to the paper's Table 1
with scipy least squares; ``predict_table1()`` reproduces the table and
``tests/test_torch_envelope.py`` checks per-cell
errors plus the qualitative findings (3x spread, XFS/ZFS target gap,
SSD write ceiling, isolation beats sharing).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

GB = 1e9


@dataclass(frozen=True)
class Media:
    name: str
    read_bw: float          # GB/s sustained sequential read
    write_bw: float         # GB/s sustained sequential write
    cpu_tax_read: float     # core-seconds per GB read through this FS
    cpu_tax_write: float    # core-seconds per GB written through this FS
    shared_controller: bool = True  # reads+writes contend when src == tgt


# initial (pre-calibration) estimates from the paper's hardware description.
# cpu taxes are core-seconds per GB (ZFS pays Merkle-tree checksumming).
MEDIA = {
    "ceph": Media("ceph", read_bw=1.1, write_bw=0.5, cpu_tax_read=0.0,
                  cpu_tax_write=0.0),
    "zfs": Media("zfs", read_bw=1.5, write_bw=0.20, cpu_tax_read=300.0,
                 cpu_tax_write=0.0),
    "xfs": Media("xfs", read_bw=2.0, write_bw=0.32, cpu_tax_read=0.0,
                 cpu_tax_write=0.0),
    "ssd": Media("ssd", read_bw=0.52, write_bw=0.50, cpu_tax_read=0.0,
                 cpu_tax_write=0.0),
}


@dataclass(frozen=True)
class Collection:
    name: str
    raw_gb: float
    index_gb: float  # paper: complete index size (positions + vectors + stored)
    n_docs: float


CW09B = Collection("CW09b", 231.0, 685.0, 50.2e6)
CW12B = Collection("CW12b", 389.0, 869.0, 52.3e6)

# storage.MEDIA_PROFILES names -> the Table-1 media they emulate, so
# measured ThrottledDirectory runs can be folded into calibrate()
PROFILE_TO_MEDIA = {"nas": "ceph", "disk": "xfs", "ssd": "ssd"}


@dataclass(frozen=True)
class MeasuredRun:
    """One measured indexing run through a ThrottledDirectory pair —
    this repo's own data point in the same units as the paper's Table 1."""

    source: str        # MEDIA key, or a MEDIA_PROFILES key (mapped)
    target: str
    raw_gb: float      # source collection bytes actually read
    index_gb: float    # final index bytes actually written (encoded)
    seconds: float     # measured envelope time

    def media_names(self) -> tuple[str, str]:
        return (PROFILE_TO_MEDIA.get(self.source, self.source),
                PROFILE_TO_MEDIA.get(self.target, self.target))


def measured_run_from_report(source: str, target: str, report: dict,
                             seconds_key: str = "t_envelope_measured_s"
                             ) -> MeasuredRun:
    """Build a MeasuredRun from ``Indexer.envelope_report()``
    taken on a durable (Directory-backed) run. ``seconds_key`` picks the
    measured clock: the full envelope (default) or ``t_io_measured_s``
    for media-only fits (in-silico runs, where host CPU time is not the
    emulated server's)."""
    return MeasuredRun(
        source=source, target=target,
        raw_gb=report["bytes_read_measured"] / GB,
        index_gb=report["index_bytes_encoded"] / GB,
        seconds=report[seconds_key])


# Table 1 of the paper, seconds (h:mm:ss converted)
TABLE1 = {
    # (source, target): (CW09b seconds, CW12b seconds)
    ("ceph", "zfs"): (8832, 10572),
    ("zfs", "zfs"): (8909, 10721),
    ("ceph", "xfs"): (5599, 6691),
    ("xfs", "xfs"): (6990, 11164),
    ("ceph", "ssd"): (3570, 4779),
    ("zfs", "ssd"): (4454, 5844),
    ("xfs", "ssd"): (3457, 4542),
    ("ssd", "ssd"): (5303, 7034),
}


@dataclass(frozen=True)
class EnvelopeParams:
    alpha: float = 2.5          # merge write amplification
    c_idx: float = 600.0        # core-seconds per raw GB for inversion
    n_cores: float = 48.0
    interference: float = 1.15  # shared-controller serialization penalty


def stage_times(source: Media, target: Media, col: Collection,
                p: EnvelopeParams) -> dict:
    G, I = col.raw_gb, col.index_gb
    written = I * p.alpha
    t_read = G / source.read_bw
    t_write = written / target.write_bw
    t_cpu = (G * (p.c_idx + source.cpu_tax_read)
             + written * target.cpu_tax_write) / p.n_cores
    shared = source.name == target.name and source.shared_controller
    if shared:
        # one medium serves both streams: it is paced by the write stream
        # and every read interleaves into it (paper: the controller splits
        # its bandwidth between reads and writes).
        t_io = (G + written) / target.write_bw * p.interference
        total = max(t_io, t_cpu)
        bound = "shared-io" if t_io >= t_cpu else "cpu"
    else:
        total = max(t_read, t_cpu, t_write)
        bound = ["read", "cpu", "write"][int(np.argmax([t_read, t_cpu,
                                                        t_write]))]
    return {"read": t_read, "cpu": t_cpu, "write": t_write,
            "total": total, "bound": bound, "written_gb": written}


def predict(source: str, target: str, col: Collection,
            media: dict | None = None, p: EnvelopeParams | None = None):
    media = media or MEDIA
    p = p or EnvelopeParams()
    return stage_times(media[source], media[target], col, p)


def predict_table1(media=None, p=None):
    out = {}
    for (s, t), actual in TABLE1.items():
        for col, act in zip((CW09B, CW12B), actual):
            st = predict(s, t, col, media, p)
            out[(s, t, col.name)] = {"pred": st["total"], "actual": act,
                                     "bound": st["bound"],
                                     "err": st["total"] / act - 1}
    return out


def calibrate(measured: tuple = (), measured_weight: float = 1.0):
    """Least-squares fit of the envelope constants to Table 1 (log-space).

    Physically known constants are PINNED, not fitted: the SSD sustains
    ~0.5 GB/s (the paper observes ~500 MB/s against the SATA ceiling) and
    Ceph sits behind 10 GbE (<= 1.25 GB/s). Free (bounded, interpretable):
    alpha (merge amplification), c_idx (core-seconds/GB inversion),
    interference (shared-controller serialization), zfs/xfs array write bw,
    zfs effective-concurrent read bw. Returns (media, params, table).

    ``measured``: optional ``MeasuredRun``s from this repo's own
    ThrottledDirectory experiments (see ``measured_run_from_report``).
    Each adds a residual ``measured_weight * log(pred / seconds)``, so the
    analytic model is fit against our measurements alongside — not only —
    the paper's Table 1."""
    from scipy.optimize import least_squares

    def unpack(x):
        alpha, c_idx, interf, zfs_w, xfs_w, zfs_tax = x
        media = dict(MEDIA)
        media["zfs"] = replace(MEDIA["zfs"], write_bw=zfs_w,
                               cpu_tax_read=zfs_tax)
        media["xfs"] = replace(MEDIA["xfs"], write_bw=xfs_w)
        p = EnvelopeParams(alpha=alpha, c_idx=c_idx, interference=interf)
        return media, p

    def residuals(x):
        media, p = unpack(x)
        table = predict_table1(media, p)
        res = [np.log(v["pred"] / v["actual"]) for v in table.values()]
        for run in measured:
            src, tgt = run.media_names()
            col = Collection(f"measured-{src}-{tgt}", run.raw_gb,
                             run.index_gb, 0.0)
            pred = stage_times(media[src], media[tgt], col, p)["total"]
            res.append(measured_weight * np.log(pred / run.seconds))
        return res

    #      alpha  c_idx interf zfs_w  xfs_w  zfs_read_tax
    x0 = np.array([2.5, 600.0, 1.15, 0.20, 0.32, 300.0])
    lo = np.array([1.5, 100.0, 0.80, 0.10, 0.15, 0.0])
    hi = np.array([4.0, 900.0, 2.00, 0.40, 0.60, 800.0])
    sol = least_squares(residuals, x0, bounds=(lo, hi), method="trf")
    media, p = unpack(sol.x)
    return media, p, predict_table1(media, p)
