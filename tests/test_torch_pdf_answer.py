"""The port's PDF ingest and answer extraction against wax_tpu's on the CPU.

`text/pdf.py` and `rag/answer.py` are verbatim copies (tests/test_torch_copies.py);
here they run through the port's own entry points. `remember_file` on the PDF
fixtures of tests/test_pdf.py must store and answer as the JAX orchestrator does, a
blank PDF must raise alike, and `extract_answer` over the port's FastRAG contexts of
tests/test_rag.py's corpus must give the JAX package's candidates.
"""
import zlib

import pytest

import wax_tpu.embed.hash_embedder as jax_hash
import wax_tpu.rag.answer as jax_answer
import wax_tpu.rag.builder as jax_builder
import wax_tpu.rag.config as jax_rag
import wax_tpu.search.engine as jax_engine
import wax_tpu.text.pdf as jax_pdf
import wax_tpu_torch.embed.hash_embedder as port_hash
import wax_tpu_torch.rag.answer as port_answer
import wax_tpu_torch.rag.builder as port_builder
import wax_tpu_torch.rag.config as port_rag
import wax_tpu_torch.search.engine as port_engine
import wax_tpu_torch.text.pdf as port_pdf
from tests.test_pdf import CMAP, _make_pdf, _obj, _stream_obj, _structured_pdf
from tests.test_rag import CORPUS
from tests.test_torch_orchestrator import _assert_same_response, _open

PDFS = {
    "plain": _make_pdf(["Hello PDF world", "Second page line about the garden shed"]),
    "flate": _make_pdf(["Compressed content about the river cabin"], compress=True),
    "escapes": _make_pdf([r"paren \( inside \) and backslash \\ done"]),
    "page_tree_flate": _structured_pdf(b"BT /F1 12 Tf (Structured page text) Tj ET",
                                       filters=b"/Filter /FlateDecode", encode=zlib.compress),
    "tounicode": _structured_pdf(
        b"BT /F1 12 Tf <004100420043> Tj ( ) Tj <005000510052> Tj ET",
        font_extra=b" /ToUnicode 6 0 R",
        extra_objs=_stream_obj(6, b"", CMAP),
    ),
    "tj_kerning": _structured_pdf(b"BT /F1 12 Tf [(spare) -400 (key) -20 (s)] TJ ET"),
    "two_pages": b"%PDF-1.5\n" + _obj(1, b"<< /Type /Catalog /Pages 2 0 R >>")
    + _obj(2, b"<< /Type /Pages /Kids [3 0 R 4 0 R] /Count 2 >>")
    + _obj(3, b"<< /Type /Page /Parent 2 0 R /Contents 5 0 R >>")
    + _obj(4, b"<< /Type /Page /Parent 2 0 R /Contents 6 0 R >>")
    + _stream_obj(5, b"", b"BT (first page) Tj ET") + _stream_obj(6, b"", b"BT (second page) Tj ET")
    + b"%%EOF\n",
    "blank": b"%PDF-1.4\n1 0 obj\n<< >>\nendobj\n%%EOF",
}


@pytest.mark.parametrize("name", list(PDFS))
def test_extract_pdf_text_equals_jax(name):
    assert port_pdf.extract_pdf_text(PDFS[name]) == jax_pdf.extract_pdf_text(PDFS[name])


def test_remember_file_pdf_equals_jax(tmp_path):
    """Every non-blank fixture is remembered as the JAX orchestrator remembers it (the
    same frames, contents and metadata) and answers alike; a blank PDF raises alike."""
    files = []
    for name, raw in PDFS.items():
        (tmp_path / f"{name}.pdf").write_bytes(raw)
        files.append(tmp_path / f"{name}.pdf")
    jo, po = _open("jax", tmp_path / "j.mv2s"), _open("port", tmp_path / "p.mv2s")
    try:
        for f in files:
            if f.stem == "blank":
                for o in (jo, po):
                    with pytest.raises(ValueError, match="no extractable text"):
                        o.remember_file(f)
                continue
            got, want = po.remember_file(f, tags=("pdf",)), jo.remember_file(f, tags=("pdf",))
            assert (got.document_id, got.chunk_ids) == (want.document_id, want.chunk_ids)
        assert po.store.frame_count() == jo.store.frame_count()
        for fid in range(jo.store.frame_count()):
            assert po.store.frame_content(fid) == jo.store.frame_content(fid)
            assert po.store.frame_meta(fid).metadata == jo.store.frame_meta(fid).metadata
        for q in ("garden shed", "river cabin", "structured page", "Hello", "first page"):
            _assert_same_response(jo.search(q), po.search(q))
    finally:
        jo.close()
        po.close()


def _contexts(pkg_engine, pkg_hash, pkg_rag, pkg_builder, device_kw):
    emb = pkg_hash.HashEmbedder(dimensions=128)
    eng = pkg_engine.HybridSearchEngine(embedder=emb, **device_kw)
    for i, text in enumerate(CORPUS):
        fid = eng.frames.put(text, timestamp_ms=1_700_000_000_000 + i * 3_600_000)
        eng.index_text(fid, text)
        eng.index_embedding(fid, emb.embed(text))
    cfg = pkg_rag.FastRAGConfig(deterministic_now_ms=1_700_010_000_000)
    return lambda q: pkg_builder.FastRAGContextBuilder(eng, cfg).build(q)


QUESTIONS = ["when was Max born", "where does Maria live", "who owns Whiskers",
             "what is the cat allergic to", "what does Max love", "what did the board approve",
             "what is the name of the golden retriever", "when did Janet adopt Whiskers",
             "what temperature to bake", "who is the architect"]


def test_extract_answer_equals_jax():
    jctx = _contexts(jax_engine, jax_hash, jax_rag, jax_builder, {})
    pctx = _contexts(port_engine, port_hash, port_rag, port_builder, {"device": "cpu"})
    found = 0
    for q in QUESTIONS:
        pc, jc = pctx(q), jctx(q)
        assert pc.render() == jc.render(), q
        want = jax_answer.extract_answer(jc, q)
        got = port_answer.extract_answer(pc, q)
        assert (got is None) == (want is None), q
        if want is not None:
            found += 1
            assert (got.text, got.lane, got.frame_id, got.score) == (
                want.text, want.lane, want.frame_id, want.score), q
    assert found >= 3
