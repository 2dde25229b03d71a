"""``chip_smoke.py``'s ``[build]`` gates on the redesigned kernels, read
from ``ptxas -v`` reports shaped as the card's compiler writes them: the
retrieval gate passes when pack, unpack, bm25_blocks (both
instantiations), compact and the four midgrid walk instantiations are
there without spills, and fails when one is missing or spills
(``unpack_kernel`` must not stand in for ``pack_kernel``); the SIMT flash
gate fails when a D = 256 instantiation (f32 or bf16) spills or is
missing."""
import importlib.util
from pathlib import Path

import pytest

from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PACK = "_ZN48_GLOBAL__N__4c14c7ce_16_postings_pack_cu_pp_pack"
BM25 = "_ZN49_GLOBAL__N__82b79dd6_16_bm25_blockmax_cu_207e091d"
KERNELS = {
    "postings_pack": [PACK + "13unpack_kernelEPK5uint4PKiPjx",
                      PACK + "11pack_kernelEPKjP5uint4Pix"],
    "bm25_blockmax": [BM25 + f"19midgrid_walk_kernelILi{n}EEEvPKiS2_PKfS4_S4_"
                             "iiPix" for n in (4, 3, 2, 1)]
    + [BM25 + "21midgrid_decode_kernelEPKjPKiS3_S1_S3_PKfS3_S5_fiPiPfS7_S7_",
       BM25 + "19bm25_compact_kernelEPK5uint4xPKiS4_S4_S2_xS4_S4_PKfS4_fPiPf"
              "S8_x",
    ] + [BM25 + f"11bm25_kernelILb{p}EEvPK5uint4PKiS5_S3_S5_PKfS5_ffPiPfS9_"
               "S8_x" for p in (0, 1)],
}
FLASH = ("_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_2c13897916flash_"
         "fwd_kernelI{t}Li{n}EEEv14CUtensorMap_stS3_S3_PKT_S6_S6_PS4_Piiiiii"
         "iiiff")
SIMT = [FLASH.format(t=t, n=n) for t in ("f", "13__nv_bfloat16")
        for n in (2, 1)]


def _report(fns, spill: str = "", drop: str = "") -> str:
    lines = ["ptxas info    : 0 bytes gmem"]
    for fn in fns:
        if drop and drop in fn:
            continue
        n = 8 if spill and spill in fn else 0
        lines += [f"ptxas info    : Compiling entry function '{fn}' for "
                  f"'sm_90a'",
                  f"ptxas info    : Function properties for {fn}",
                  f"    0 bytes stack frame, {n} bytes spill stores, {n} "
                  f"bytes spill loads",
                  "ptxas info    : Used 32 registers, used 0 barriers"]
    return "\n".join(lines)


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_gate_passes_without_spills(chip_smoke, monkeypatch):
    monkeypatch.setattr(_build, "build_report",
                        lambda name: _report(KERNELS[name]))
    got = chip_smoke.retrieval_build_check()
    assert set(got) == {"pack_kernel", "unpack_kernel", "bm25_compact_kernel",
                        "bm25_kernel<0>", "bm25_kernel<1>",
                        *(f"midgrid_walk_kernel<{n}>" for n in range(1, 5))}
    assert all(p == {"spill_bytes": 0, "registers": 32}
               for p in got.values())


@pytest.mark.parametrize("kernel", ["13unpack_kernel", "11pack_kernel",
                                    "19bm25_compact_kernel", "ILi3E",
                                    "ILb0E", "ILb1E"])
@pytest.mark.parametrize("fault", ["spill", "drop"])
def test_build_gate_fails_on_a_spill_or_a_missing_kernel(chip_smoke,
                                                         monkeypatch, kernel,
                                                         fault):
    monkeypatch.setattr(_build, "build_report", lambda name: _report(
        KERNELS[name], **{fault: kernel}))
    with pytest.raises(AssertionError, match="missing from the ptxas report "
                                             "or spills"):
        chip_smoke.retrieval_build_check()


def test_simt_flash_gate_passes_without_spills(chip_smoke, monkeypatch):
    monkeypatch.setattr(_build, "build_report", lambda name: _report(SIMT))
    got = chip_smoke.simt_build_check()
    assert set(got) == {"f32_NC1", "f32_NC2", "bf16_NC1", "bf16_NC2"}


@pytest.mark.parametrize("kernel", ["IfLi2E", "I13__nv_bfloat16Li2E"])
@pytest.mark.parametrize("fault", ["spill", "drop"])
def test_simt_flash_gate_fails_on_a_d256_spill_or_a_missing_kernel(
        chip_smoke, monkeypatch, kernel, fault):
    monkeypatch.setattr(_build, "build_report", lambda name: _report(
        SIMT, **{fault: kernel}))
    with pytest.raises(AssertionError, match="missing or spills"):
        chip_smoke.simt_build_check()
