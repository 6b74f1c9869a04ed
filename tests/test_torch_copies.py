"""The port's verbatim copies of JAX-free `wax_tpu` modules stay verbatim.

`wax_tpu/__init__.py` imports jax eagerly, so the port keeps its own copy of every
host module it needs. Each copy below must equal its `wax_tpu` source once its header
(the lines through "Keep the two in step.") is stripped and `wax_tpu_torch.` is mapped
back to `wax_tpu.`. `rag/builder.py` is the JAX module's text with its imports
pointed at the port, so it is held the same way.

Changed copies are left out by name, each for the change its header states:
`search/match.py` (evaluated over a position index of the port builder's token log),
`utils/profiling.py` (`device_trace` on torch.profiler) and `native/build.py` (builds
into wax_tpu_torch/_build/native/). `search/snippet.py` needs no change: it runs the
port's `match_search` on a one-document port builder, so it is held verbatim.
"""
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
HEADER_END = "Keep the two in step."

COPIES = [
    "types.py", "version.py", "index/frames.py",
    "storage/codec.py", "storage/fdfile.py", "storage/format.py", "storage/wal.py",
    "storage/compression.py", "storage/store.py",
    "native/lz4.cpp", "native/bpe.cpp", "native/hnsw.cpp",
    "text/analyzer.py", "text/classifier.py", "text/token_counter.py", "text/bpe.py",
    "text/chunker.py", "text/match_query.py", "text/wordpiece.py", "text/unicode61_tables.py",
    "structured/memory.py", "embed/hash_embedder.py", "embed/memoizer.py", "embed/provider.py",
    "search/fts_preprocess.py", "search/rerank.py", "search/engine_cache.py", "search/snippet.py",
    "rag/config.py", "rag/context.py", "rag/importance.py", "rag/surrogates.py", "rag/builder.py",
    "orchestrator/config.py", "orchestrator/stats.py", "utils/concurrency.py",
]
CHANGED = ["search/match.py", "utils/profiling.py", "native/build.py"]


def _strip_header(text: str) -> str:
    lines = text.splitlines(keepends=True)
    for i, line in enumerate(lines[:6]):
        if HEADER_END in line:
            return "".join(lines[i + 1 :])
    raise AssertionError("no copy header (a source line ending in 'Keep the two in step.')")


@pytest.mark.parametrize("rel", COPIES)
def test_copy_equals_its_source(rel):
    port = _strip_header((REPO / "wax_tpu_torch" / rel).read_text())
    assert port.replace("wax_tpu_torch.", "wax_tpu.") == (REPO / "wax_tpu" / rel).read_text()


def test_every_copy_header_is_held():
    """Each port file whose header names a `wax_tpu` source is either held verbatim
    above or listed as a changed copy; the vendored BPE vocabulary is byte-equal."""
    headed = set()
    for p in (REPO / "wax_tpu_torch").rglob("*"):
        if p.suffix in (".py", ".cpp") and "_build" not in p.parts:
            head = "".join(p.read_text().splitlines(keepends=True)[:6])
            if HEADER_END in head and "wax_tpu/" in head:
                headed.add(p.relative_to(REPO / "wax_tpu_torch").as_posix())
    assert headed == set(COPIES) | set(CHANGED)
    vocab = "text/resources/cl100k_base.tiktoken.gz"
    assert (REPO / "wax_tpu_torch" / vocab).read_bytes() == (REPO / "wax_tpu" / vocab).read_bytes()
