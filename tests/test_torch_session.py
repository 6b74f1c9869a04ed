"""The port's WaxSession against wax_tpu's on the CPU.

Each case mirrors one of wax_tpu's tests/test_session.py: it runs the same steps
through both packages' `open_session` (the port's with `device="cpu"`) over the same
texts and HashEmbedder vectors, in stores of its own, and requires equal answers:
`SearchResponse`s by `_assert_same_response` (frame ids, scores within rtol 1e-6,
previews, sources, lane counts, warnings), frame ids and engine kinds. The vector
engines are flat, auto and hnsw; the cases cover put and search, commit and reopen,
put_batch, delete, read-only sessions, the WAL catch-up on open, and a stale analyzer.
"""
import logging

import pytest
import torch

import wax_tpu.embed.hash_embedder as jax_hash
import wax_tpu.index.lex as jax_lex
import wax_tpu.session as jax_session
import wax_tpu.storage.store as jax_store
import wax_tpu.types as jax_types
import wax_tpu_torch.embed.hash_embedder as port_hash
import wax_tpu_torch.index.lex as port_lex
import wax_tpu_torch.session as port_session
import wax_tpu_torch.storage.store as port_store
import wax_tpu_torch.types as port_types
from tests.test_torch_orchestrator import _assert_same_response

PKGS = {
    "jax": (jax_session, jax_store, jax_hash, jax_types, jax_lex),
    "port": (port_session, port_store, port_hash, port_types, port_lex),
}
ENGINES = ["flat", "auto", "hnsw"]
TEXTS = [f"{w} memory note {i} about the {p}" for i, (w, p) in enumerate(
    (w, p) for w in ("walrus", "harbour", "lantern", "orchard", "glacier") for p in ("cabin", "river", "market"))]


def _open(pkg, path, engine="auto", readonly=False):
    session, store, *_ = PKGS[pkg]
    kw = {"device": "cpu"} if pkg == "port" else {}
    return session.open_session(path, dim=64, options=store.StoreOptions(wal_size=512 * 1024), readonly=readonly,
                                vector_preference=engine, **kw)


def _emb(pkg):
    return PKGS[pkg][2].HashEmbedder(64)


def _both(tmp_path, steps, **kw):
    """Run `steps(pkg, tmp)` in a directory of its own for each package."""
    out = {}
    for pkg in PKGS:
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = steps(pkg, d, **kw)
    return out["jax"], out["port"]


def _same(a, b) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, (int, str, bytes, bool, tuple, type(None))):
            assert x == y
        else:
            _assert_same_response(x, y)


def _search(pkg, s, query, mode=None, embedding=None):
    types = PKGS[pkg][3]
    kw = {"mode": types.SearchMode[mode]} if mode else {}
    if embedding is not None:
        kw["embedding"] = embedding
    return s.search(types.SearchRequest(query=query, **kw))


def _put_commit_reopen(pkg, d, engine):
    emb = _emb(pkg)
    out = []
    with _open(pkg, d / "s.wxs", engine) as s:
        fid = s.put("the session api stores this", embedding=emb.embed("the session api stores this"))
        fids = s.put_batch(TEXTS, embeddings=emb.embed_batch(TEXTS), metadatas=[{"n": str(i)} for i in range(15)])
        out += [fid, tuple(fids), s.engine.vector.kind, s.search("session api"), s.search("walrus cabin")]
        assert pkg == "jax" or s.engine.vector.device == s.engine.device == torch.device("cpu")
        out.append(_search(pkg, s, "lantern river", "VECTOR_ONLY", emb.embed("lantern memory note about the river")))
        out.append(s.store.frame_meta(fids[3]).metadata["n"])
        out.append(s.commit())
    with _open(pkg, d / "s.wxs", engine) as s2:
        m = s2.store.toc.manifests
        out += [s2.engine.vector.kind, "lex" in m and "vec" in m, len(s2.engine.vector)]
        out += [s2.search("session api stores"), s2.search("glacier market")]
        out.append(_search(pkg, s2, "orchard", "TEXT_ONLY"))
        out.append(_search(pkg, s2, "orchard cabin", "VECTOR_ONLY", emb.embed("orchard memory note about the cabin")))
        out.append(s2.commit() > out[7])
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_put_commit_reopen(tmp_path, engine):
    _same(*_both(tmp_path, _put_commit_reopen, engine=engine))


def _delete_and_upsert(pkg, d, engine):
    emb = _emb(pkg)
    with _open(pkg, d / "u.wxs", engine) as s:
        s.put_batch(TEXTS, embeddings=emb.embed_batch(TEXTS))
        fid = s.put("old crocodile info", embedding=emb.embed("old crocodile info"))
        out = [s.delete(fid), s.delete(fid)]
        fid2 = s.put("new crocodile info", embedding=emb.embed("new crocodile info"))
        out += [fid2, s.search("crocodile info"), len(s.engine.vector), s.delete(2), s.search("walrus river")]
        bid = s.put(b"\x00\x01\x02binaryblob", index_text=False)
        out += [bid, s.store.frame_content(bid), s.search("binaryblob")]
        s.commit()
    with _open(pkg, d / "u.wxs", engine) as s2:
        out += [s2.search("crocodile info"), len(s2.engine.vector), s2.search("walrus river")]
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_delete_and_upsert(tmp_path, engine):
    _same(*_both(tmp_path, _delete_and_upsert, engine=engine))


def _readonly(pkg, d, engine):
    emb = _emb(pkg)
    store = PKGS[pkg][1]
    with _open(pkg, d / "r.wxs", engine) as s:
        s.put_batch(TEXTS, embeddings=emb.embed_batch(TEXTS))
        s.commit()
    ro = _open(pkg, d / "r.wxs", engine, readonly=True)
    try:
        out = [ro.readonly, ro.engine.vector.kind, ro.search("readable harbour market")]
        with pytest.raises(store.StoreError):
            ro.put("nope")
    finally:
        ro.close()
    with pytest.raises(store.StoreError):
        _open(pkg, d / "missing.wxs", engine, readonly=True)
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_readonly_session(tmp_path, engine):
    _same(*_both(tmp_path, _readonly, engine=engine))


def _wal_catch_up(pkg, d, engine):
    """Puts left in the WAL (no commit) reach both engines on the next open, and its
    commit persists them."""
    emb = _emb(pkg)
    p = d / "w.wxs"
    with _open(pkg, p, engine) as s:
        s.put_batch(TEXTS[:6], embeddings=emb.embed_batch(TEXTS[:6]))
        s.commit()
    s = _open(pkg, p, engine)
    s.put("uncommitted walrus fact zanzibar", embedding=emb.embed("uncommitted walrus fact zanzibar"))
    s.put_batch(TEXTS[6:], embeddings=emb.embed_batch(TEXTS[6:]))
    s.store.close()  # no commit: the new frames live only in the WAL
    with _open(pkg, p, engine) as s2:
        out = [len(s2.engine.vector), s2.search("zanzibar walrus"), s2.search("glacier cabin")]
        out.append(_search(pkg, s2, "zanzibar", "TEXT_ONLY"))
        s2.commit()
    with _open(pkg, p, engine) as s3:
        out += [len(s3.engine.vector), s3.search("zanzibar walrus"), s3.store.pending_embeddings() == []]
    return out


@pytest.mark.parametrize("engine", ENGINES)
def test_wal_catch_up(tmp_path, engine):
    _same(*_both(tmp_path, _wal_catch_up, engine=engine))


def _stale_analyzer(pkg, d, monkeypatch, caplog):
    emb = _emb(pkg)
    p = d / "stale.wxs"
    with _open(pkg, p) as s:
        fid = s.put("stale analyzer guard document", embedding=emb.embed("x"))
        s.commit()
    monkeypatch.setattr(PKGS[pkg][4], "ANALYZER_VERSION", "u61-next")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="wax_tpu"):
        with _open(pkg, p) as s2:
            out = [fid, s2.search("analyzer guard"), any("analyzer" in r.message for r in caplog.records)]
            s2.put("second doc after rebuild", embedding=emb.embed("y"))
            s2.commit()
    with _open(pkg, p) as s3:
        out += [s3.store.toc.manifests["lex"].attrs["analyzer"], s3.search("second doc")]
    monkeypatch.undo()
    return out


def test_stale_analyzer_rebuilds(tmp_path, monkeypatch, caplog):
    jax_out, port_out = _both(tmp_path, _stale_analyzer, monkeypatch=monkeypatch, caplog=caplog)
    _same(jax_out, port_out)
    assert port_out[2] and port_out[3] == "u61-next"


def test_hnsw_store_crosses_packages(tmp_path):
    """A session store with an hnsw vector segment, written by either package, opens in
    the other with equal answers."""
    for writer, reader in (("jax", "port"), ("port", "jax")):
        p = tmp_path / f"{writer}.wxs"
        emb = _emb(writer)
        with _open(writer, p, "hnsw") as s:
            s.put_batch(TEXTS, embeddings=emb.embed_batch(TEXTS))
            s.commit()
            s.put("a WAL-only harbour note", embedding=emb.embed("a WAL-only harbour note"))
        queries = ("harbour note", "orchard river", "walrus")
        with _open(writer, p, "hnsw", readonly=True) as w:
            want = [w.search(q) for q in queries]
        with _open(reader, p, "hnsw", readonly=True) as r:
            assert r.engine.vector.kind == "hnsw"
            for a, b in zip(want, [r.search(q) for q in queries]):
                _assert_same_response(a, b)
