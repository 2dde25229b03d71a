"""The port stands alone: no module of ``src/repro_torch`` imports JAX or
anything of the JAX package ``repro`` (checked in a fresh interpreter and
by a source scan), and no kernel call sits under a ``try`` that could
fall back to the plain version."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
# calls that reach a hand-written kernel (the ops and what wraps them)
KERNEL_CALLS = {"pack", "unpack", "bm25_blocks", "bm25_blocks_partials",
                "bm25_blocks_midgrid", "lib", "build_all", "pp_pack",
                "pp_unpack", "bm25_midgrid", "_decode_score_blocks",
                "score_survivors", "score_survivors_midgrid",
                "build_block_index", "_finish_index", "search_batched",
                "refresh", "topk_pruned", "pruned_eval", "serve_retrieval",
                "bm25_blocks_compact", "bm25_compact",
                # the storage codec's pfor streams (pack/unpack kernels)
                "_enc_pfor", "unpack_streams", "unpack_segment",
                "_enc_stream", "_dec_stream",
                "encode_segment", "decode_segment", "write_segment",
                "read_segment", "open_latest", "open_latest_degraded",
                "open_searcher", "_open_latest_full", "commit",
                # the flash-attention op, its launcher, its C entry points,
                # the model's attention call and the LM entry points above
                "flash_attention", "launch", "flash_attention_fwd",
                "flash_attention_tc_fwd", "_attention", "prefill",
                "generate", "serve_lm"}


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_repro():
    names = [m for _, m in _modules()]
    code = (
        "import importlib, json, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'jaxlib')) or m == 'repro'"
        " or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       env={"PYTHONPATH": str(REPO / "src"),
                            "PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
    assert len(names) >= 20


def test_no_jax_or_repro_import_lines():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)")
    bad = [f"{p.relative_to(REPO)}:{i}: {line.strip()}"
           for p, _ in _modules()
           for i, line in enumerate(p.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, "\n".join(bad)


def _called_names(node):
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            yield f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)


def test_no_kernel_call_under_try():
    bad = []
    for path, mod in _modules():
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Try):
                continue
            if mod.startswith("repro_torch.kernels"):
                bad.append(f"{mod}:{node.lineno}: try in a kernel module")
            hit = set(_called_names(ast.Module(body=node.body,
                                               type_ignores=[])))
            if hit & KERNEL_CALLS:
                bad.append(
                    f"{mod}:{node.lineno}: {sorted(hit & KERNEL_CALLS)}")
    assert not bad, "\n".join(bad)
