"""The port stands alone: no module of ``src/repro_torch`` and no
``examples/torch_*.py`` imports JAX or anything of the JAX package
``repro`` (checked in a fresh interpreter and by a source scan), and no
kernel call sits under a ``try`` that could fall back to the plain
version. The one ``try`` on the refresh daemon's path only hands the
error it died of to ``close()``, which raises it; so do the replica
syncer's poller (to its ``close()``) and the replica process's command
loop (to the parent, whose ``RemoteReplica._call`` raises it)."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))
# the modules this slice ported (each must be among those checked)
SLICE8 = {"repro_torch.core.envelope", "repro_torch.core.tokenize",
          "repro_torch.io", "repro_torch.io.reader",
          "repro_torch.serving.steady", "repro_torch.core.indexer"}
SLICE9 = {"repro_torch.replication", "repro_torch.replication.fleet",
          "repro_torch.replication.publisher",
          "repro_torch.replication.server",
          "repro_torch.replication.syncer", "repro_torch.core.searcher"}
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
                # a replica's decode of shipped segments
                "_install",
                # the flash-attention op, its launcher, its C entry points,
                # the model's attention call and the LM entry points above
                "flash_attention", "launch", "flash_attention_fwd",
                "flash_attention_tc_fwd", "_attention", "prefill",
                "generate", "serve_lm"}


def _modules(examples: bool = False):
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield path, ".".join(parts)
    if examples:
        for path in EXAMPLES:
            yield path, f"examples.{path.stem}"


def test_importing_every_module_loads_no_jax_and_no_repro():
    names = [m for _, m in _modules()]
    assert SLICE8 | SLICE9 <= set(names)
    assert {p.stem for p in EXAMPLES} == {
        "torch_quickstart", "torch_index_corpus", "torch_serve_retrieval",
        "torch_serve_fleet"}
    code = (
        "import importlib, importlib.util, json, sys\n"
        f"for m in {names!r}:\n"
        "    importlib.import_module(m)\n"
        f"for p in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('ex', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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
           for p, _ in _modules(examples=True)
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
    for path, mod in _modules(examples=True):
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


def _methods(tree):
    return {n.name: n for n in ast.walk(tree)
            if isinstance(n, ast.FunctionDef)}


def _own_nodes(fn):
    """``fn``'s nodes, without those of functions defined inside it."""
    todo = list(ast.iter_child_nodes(fn))
    while todo:
        n = todo.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.Lambda)):
            todo.extend(ast.iter_child_nodes(n))


def _reaches_kernel(fn, methods, seen=()):
    """A kernel call in ``fn``, or in a method of the same module it
    calls as ``self.<name>()``, transitively."""
    names = set(_called_names(fn))
    if names & KERNEL_CALLS:
        return True
    return any(_reaches_kernel(methods[n], methods, seen + (n,))
               for n in names if n in methods and n not in seen)


def test_daemon_and_merge_paths_catch_no_kernel_failure():
    """Followed through the functions each calls: no ``try`` with a
    handler on the refresh daemon's, the merge threads' or serving's
    path, nor on a replica's (sync, decode, serving), wraps a kernel
    call, except four that hand what their thread or process died of to
    the caller, who raises it: the daemon's (stored in ``_refresh_error``;
    ``close()`` raises it), the open-loop runner's churn thread
    (``churn_err``; ``run_open_loop`` raises it), the replica syncer's
    poller (``_error``; ``close()`` raises it) and the replica process's
    command loop (an ``"err"`` reply; ``RemoteReplica._call`` raises
    it)."""
    found = {}
    trees = {rel: ast.parse((PKG / rel).read_text())
             for rel in ("core/indexer.py", "core/merge.py",
                         "serving/steady.py", "serving/query_scheduler.py",
                         "replication/syncer.py", "replication/server.py")}
    for rel, tree in trees.items():
        methods = _methods(tree)
        for fn in methods.values():
            for node in _own_nodes(fn):
                if isinstance(node, ast.Try) and node.handlers \
                        and _reaches_kernel(ast.Module(
                            body=node.body, type_ignores=[]), methods):
                    found[(rel, fn.name)] = node
    handed = {("core/indexer.py", "_refresh_daemon"):
              ("self._refresh_error = e", "close", "err"),
              ("serving/steady.py", "_churn_loop"):
              ("churn_err.append(e)", "run_open_loop", "churn_err[0]"),
              ("replication/syncer.py", "_follow"):
              ("self._error = e", "close", "err"),
              ("replication/server.py", "replica_main"):
              ("reply = ('err', f'{type(e).__name__}: {e}')", "_call",
               "RemoteReplicaError(f'{self.replica_id}: {cmd}: {out}')")}
    assert set(found) == set(handed)
    for (rel, _), node in found.items():
        store, raiser, raised = handed[(rel, _)]
        (handler,) = node.handlers
        assert handler.name == "e"
        assert ast.unparse(handler.body[0]) == store
        assert all(isinstance(st, (ast.Return, ast.Assign, ast.Expr))
                   for st in handler.body)
        fn = _methods(trees[rel])[raiser]
        assert any(isinstance(n, ast.Raise) and n.exc is not None
                   and ast.unparse(n.exc) == raised for n in ast.walk(fn))
