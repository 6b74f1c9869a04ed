"""The port's photo and video orchestrators against wax_tpu's on the CPU.

Mirrors tests/test_multimodal.py case by case: each scenario runs through both
packages (the port's orchestrators on `device="cpu"`) with the same stub providers,
the same deterministic multimodal embedder and fixed clocks, and everything it
returns (ingest results, recall hits with scores, summaries, evidence, regions,
frame metadata, rewrite reports but their `elapsed_ms`) must be equal, scores within
rtol 1e-6. The remap cases forget an asset or a video, rewrite the inner store and
check that the wrappers' roots follow the remap in both packages alike.
"""
import dataclasses
import itertools

import numpy as np
import pytest

import wax_tpu.embed.hash_embedder as jax_hash
import wax_tpu.multimodal.photo as jax_photo
import wax_tpu.multimodal.protocols as jax_protocols
import wax_tpu.multimodal.video as jax_video
import wax_tpu.orchestrator.config as jax_config
import wax_tpu.storage.store as jax_store
import wax_tpu.text.token_counter as jax_tc
import wax_tpu.types as jax_types
import wax_tpu_torch.embed.hash_embedder as port_hash
import wax_tpu_torch.multimodal.photo as port_photo
import wax_tpu_torch.multimodal.protocols as port_protocols
import wax_tpu_torch.multimodal.video as port_video
import wax_tpu_torch.orchestrator.config as port_config
import wax_tpu_torch.storage.store as port_store
import wax_tpu_torch.text.token_counter as port_tc
import wax_tpu_torch.types as port_types
from tests.test_multimodal import StubCaption, StubOCR, StubTranscript

T0 = 1_700_000_000_000


@dataclasses.dataclass
class Pkg:
    name: str
    photo: object
    video: object
    protocols: object
    hashing: object
    config: object
    store: object
    types: object
    tc: object

    def oc(self):
        clock = itertools.count(T0, 60_000)
        return self.config.OrchestratorConfig(store=self.store.StoreOptions(wal_size=512 * 1024),
                                              clock_ms=lambda: next(clock))

    def kw(self):
        return {"device": "cpu"} if self.name == "port" else {}

    def photo_orch(self, path, embedder=None, ocr=None, caption=None, **cfg):
        return self.photo.PhotoRAGOrchestrator(
            path, embedder=embedder if embedder is not None else MMEmbedder(self), ocr_provider=ocr,
            caption_provider=caption, config=self.photo.PhotoRAGConfig(orchestrator=self.oc(), **cfg),
            **self.kw())

    def video_orch(self, path, **cfg):
        return self.video.VideoRAGOrchestrator(
            path, self.hashing.HashEmbedder(64), self.video.VideoRAGConfig(orchestrator=self.oc(), **cfg),
            **self.kw())


PKGS = {
    "jax": Pkg("jax", jax_photo, jax_video, jax_protocols, jax_hash, jax_config, jax_store, jax_types, jax_tc),
    "port": Pkg("port", port_photo, port_video, port_protocols, port_hash, port_config, port_store, port_types,
                port_tc),
}


class MMEmbedder:
    """tests/test_multimodal.py's DeterministicMultimodalEmbedder on a package's own
    HashEmbedder: hashed text, images near their descriptive text."""

    def __init__(self, pkg: Pkg, dim: int = 64):
        self._h = pkg.hashing.HashEmbedder(dim)

    @property
    def dimensions(self):
        return self._h.dimensions

    @property
    def identity(self):
        return "det-multimodal"

    def embed_text(self, text):
        return self._h.embed(text)

    def embed_image(self, image):
        return self._h.embed(f"image:{image if isinstance(image, str) else 'pixels'}")


@pytest.fixture(autouse=True)
def fixed_clocks(monkeypatch):
    for mod in (jax_store, port_store, jax_photo, port_photo, jax_video, port_video):
        monkeypatch.setattr(mod, "now_ms", lambda: T0 + 7 * 10**8)


def _plain(x):
    """Dataclasses to dicts (recursively), `elapsed_ms` dropped."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x) if f.name != "elapsed_ms"}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _assert_equal(a, b, path="") -> None:
    if isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _assert_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


def _spans(p, items):
    return StubTranscript([p.protocols.TranscriptSpan(*it) for it in items])


def _blocks(p, items):
    """(text, bbox or None for the whole image, confidence) triples."""
    return StubOCR([p.protocols.OCRBlock(t, bbox or (0.0, 0.0, 1.0, 1.0), c) for t, bbox, c in items])


# ------------------------------------------------------------------------ scenarios ----
def video_ingest_and_recall(p, tmp):
    with p.video_orch(tmp / "v.wxs") as v:
        res = v.ingest("vid1", duration_ms=30_000, transcript_provider=_spans(p, [
            (0, 9_000, "welcome to the cooking show"), (9_500, 21_000, "today we bake sourdough bread"),
            (21_500, 30_000, "let the dough rest overnight")]), keyframe_refs=["kf0.jpg", "kf1.jpg", "kf2.jpg"])
        return [res, v.recall("baking sourdough bread"), v.recall_context("dough overnight")]


def video_overlap_threshold(p, tmp):
    with p.video_orch(tmp / "v.wxs") as v:
        return [v.ingest("vid2", duration_ms=20_000, transcript_provider=_spans(p, [(9_800, 10_200, "tiny")]))]


def video_dedupe_and_cap(p, tmp):
    with p.video_orch(tmp / "v.wxs") as v:
        out = [v.ingest("vid3", 5_000, _spans(p, [(0, 5_000, "hello world")])) for _ in range(2)]
        spans = [(i * 10_000, i * 10_000 + 9_000, f"part {i}") for i in range(500)]
        out.append(v.ingest("vid4", duration_ms=5_000_000, transcript_provider=_spans(p, spans)))
        out.append(v.recall("part 17", top_k=5))
        return out


def video_persistence(p, tmp):
    with p.video_orch(tmp / "v.wxs") as v:
        v.ingest("vid5", 8_000, _spans(p, [(0, 8_000, "persistent transcript content")]))
        v.flush()
    with p.video_orch(tmp / "v.wxs") as v2:
        return [v2.ingest("vid5", 8_000, _spans(p, [(0, 8_000, "x")])), v2.recall("persistent transcript")]


def _default_photo(p, tmp, **cfg):
    return p.photo_orch(tmp / "p.wxs", ocr=_blocks(p, [("EXIT sign above the door", None, 0.9)]),
                        caption=StubCaption("a red door in a brick wall"), **cfg)


def photo_ingest_and_recall(p, tmp):
    with _default_photo(p, tmp) as ph:
        res = ph.ingest("asset1", "img1", taken_at_ms=T0, gps=(41.39, 2.17), thumbnail_ref="thumb1.jpg",
                        tags=["holiday"])
        return [res, ph.recall("red door brick"), ph.recall("exit sign"), ph.recall("red door exit sign")]


def photo_constraints(p, tmp):
    with _default_photo(p, tmp) as ph:
        ph.ingest("bcn", "img1", gps=(41.39, 2.17), taken_at_ms=1_000_000)
        ph.ingest("nyc", "img2", gps=(40.71, -74.00), taken_at_ms=2_000_000)
        return [ph.recall("red door brick", near=(41.3901, 2.1702)),
                ph.recall("red door", time_range=p.types.TimeRange(after_ms=1_500_000)),
                ph.ingest("bcn", "img1"), p.photo.gps_bin(41.39222, 2.17111)]


def photo_ocr_blocks_and_regions(p, tmp):
    blocks = [("EXIT", (0.1, 0.1, 0.2, 0.05), 0.95), ("FIRE HOSE", (0.6, 0.7, 0.3, 0.1), 0.80),
              ("B", (0.15, 0.12, 0.2, 0.1), 0.9)]
    with p.photo_orch(tmp / "p.wxs", ocr=_blocks(p, blocks)) as ph:
        res = ph.ingest("a1", "img")
        metas = [ph.inner.store.frame_meta(f) for f in (*res.ocr_block_frames, *res.region_frames,
                                                         res.ocr_summary_frame)]
        return [res, [(m.kind, m.metadata, m.search_text) for m in metas], ph.recall("fire hose exit")]


def photo_pipeline_version_bump(p, tmp):
    emb = MMEmbedder(p)
    ph = p.photo_orch(tmp / "p.wxs", embedder=emb, pipeline_version="v1")
    out = [ph.ingest("a1", "img", caption_text="old caption about canals"), ph.ingest("a1", "img")]
    ph.flush()
    ph.close()
    ph2 = p.photo_orch(tmp / "p.wxs", embedder=emb, pipeline_version="v2")
    out += [ph2.ingest("a1", "img", caption_text="new caption about canals"), ph2.recall("caption about canals")]
    ph2.close()
    return out


def photo_summary_budget(p, tmp):
    blocks = [(f"line {i} with several words of text", None, 0.9) for i in range(30)]
    with p.photo_orch(tmp / "p.wxs", ocr=_blocks(p, blocks), caption=StubCaption("busy poster full of text"),
                      max_text_tokens=40) as ph:
        ph.ingest("a1", "img")
        ctx = ph.recall_context("poster text")
        return [ctx, [p.tc.TokenCounter.shared().count(i.summary) for i in ctx.items]]


def video_forget_and_rewrite(p, tmp):
    with p.video_orch(tmp / "v.wxs") as v:
        v.ingest("vid-a", 10_000, _spans(p, [(0, 9_000, "alpha topic segment")]))
        v.ingest("vid-b", 10_000, _spans(p, [(0, 9_000, "bravo topic segment")]))
        out = [v.forget("vid-a"), v.forget("vid-a"), v.flush()]
        out.append(v.inner.maintainer.rewrite_live_set())
        out.append(sorted(v._ingested.items()))
        out.append(v.inner.store.frame_meta(v._ingested["vid-b"][0]).metadata)
        out += [v.recall("bravo topic"), v.recall("alpha topic")]
        out.append(v.ingest("vid-a", 10_000, _spans(p, [(0, 9_000, "alpha topic segment")])))
        return out


def photo_forget_and_rewrite(p, tmp):
    with p.photo_orch(tmp / "p.wxs", ocr=_blocks(p, [("EXIT", (0.1, 0.1, 0.2, 0.05), 0.9)])) as ph:
        for i, (image, caption) in enumerate([("sunset", "a sunset over the bay"),
                                              ("mountain", "a mountain trail hike"),
                                              ("harbour", "boats in the old harbour")]):
            ph.ingest(f"img-{i}", image=image, caption_text=caption, taken_at_ms=T0 + i)
        out = [ph.forget("img-0"), ph.flush(), ph.inner.maintainer.rewrite_live_set()]
        out.append(sorted(ph._ingested.items()))
        out += [ph.recall("mountain trail"), ph.recall("sunset bay"), ph.recall("exit harbour")]
        return out


SCENARIOS = [video_ingest_and_recall, video_overlap_threshold, video_dedupe_and_cap, video_persistence,
             photo_ingest_and_recall, photo_constraints, photo_ocr_blocks_and_regions,
             photo_pipeline_version_bump, photo_summary_budget, video_forget_and_rewrite,
             photo_forget_and_rewrite]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__ for s in SCENARIOS])
def test_scenario_equals_jax(tmp_path, scenario):
    out = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        out[name] = _plain(scenario(PKGS[name], tmp_path / name))
    _assert_equal(out["jax"], out["port"])


def test_remap_follows_rewrite_in_port(tmp_path):
    """The port's photo wrapper keeps its roots through the rewrite: the surviving
    assets' roots are the rewritten store's roots, the forgotten one is gone and can
    be ingested again."""
    p = PKGS["port"]
    with p.photo_orch(tmp_path / "p.wxs") as ph:
        for i in range(4):
            ph.ingest(f"a{i}", image=f"img{i}", caption_text=f"caption number {i} of a lake", taken_at_ms=T0 + i)
        ph.forget("a1")
        ph.flush()
        before = dict(ph._ingested)
        ph.inner.maintainer.rewrite_live_set()
        assert set(ph._ingested) == {"a0", "a2", "a3"}
        for aid, (root, _) in ph._ingested.items():
            meta = ph.inner.store.frame_meta(root)
            assert meta.kind == p.photo.PHOTO_ROOT_KIND and meta.metadata["asset_id"] == aid
            assert root <= before[aid][0]
        assert not ph.ingest("a1", image="img1", caption_text="back again").skipped_duplicate
        assert ph.inner.engine.vector.device.type == "cpu"
