"""Maintenance: surrogate optimization, index compaction, live-set rewrite.

Mirrors the reference's maintenance suite (reference:
Sources/Wax/Orchestrator/MemoryOrchestrator+Maintenance.swift —
optimizeSurrogates :33-157 (chunk frames -> extractive summaries -> surrogate frames
with source-hash/algo/version metadata, skip-if-current), compactIndexes :160-171,
rewriteLiveSet :176-289 (full copy to a new file dropping dead payloads, verify +
rollback), scheduled rewrite gates :289-380 per README:175-186).

Live-set rewrite detail that differs by necessity: frame ids are dense, so dropping
dead frames renumbers the survivors. The rewrite computes an id remap and applies it
to parent/supersede links, index builders, access stats, and structured-memory
evidence rows before flushing the new file.

PyTorch port of `wax_tpu.orchestrator.maintenance`, with its reports, gates and
rebuilds. Maintenance rebuilds the engine's builders on the host; the engine's next
search takes a fresh snapshot onto its `device`. Differences from the JAX module:

- the lexical index rebuilds through `LexIndexBuilder.compact()` and `.remapped()`
  (the port's builder keeps flat posting and token logs, not the JAX builder's
  per-term dicts, so the rewrite cannot fill a fresh builder's fields directly);
- after either rebuild both of the engine's lexical snapshot caches are dropped (the
  rebuilt builder's generation restarts, so it could meet a cached one).
"""
from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass
from pathlib import Path

from wax_tpu_torch.index.dense import DenseIndexBuilder
from wax_tpu_torch.orchestrator.stats import AccessStats
from wax_tpu_torch.rag.surrogates import SurrogateTier, generate_surrogate
from wax_tpu_torch.storage.store import WaxStore
from wax_tpu_torch.types import FrameKind, FrameStatus, now_ms

__all__ = ["MaintenanceReport", "LiveSetRewriteReport", "Maintainer"]

SURROGATE_ALGO = "mmr-extractive-v1"


@dataclass(frozen=True)
class MaintenanceReport:
    surrogates_created: int = 0
    surrogates_current: int = 0
    frames_scanned: int = 0


@dataclass(frozen=True)
class LiveSetRewriteReport:
    executed: bool
    reason: str
    frames_before: int = 0
    frames_after: int = 0
    bytes_before: int = 0
    bytes_after: int = 0
    elapsed_ms: float = 0.0


def _drop_lex_snapshots(engine) -> None:
    engine._lex_snap, engine._lex_gen = None, -1
    engine._lex_sharded_snap, engine._lex_sharded_gen = None, -1


def _reset_vector_snapshot(vec) -> None:
    """After a new builder: IVF buckets must fully rebuild; the auto engine's builder
    setter already dropped its flat snapshot, IVF candidate and route."""
    if hasattr(vec, "_needs_full"):
        vec._needs_full = True
    if hasattr(vec, "_snap"):
        vec._snap, vec._snap_gen = None, -1


class Maintainer:
    """Maintenance operations over a MemoryOrchestrator."""

    def __init__(self, orch):
        self.orch = orch
        self._last_rewrite_ms = 0
        self._flushes_since_rewrite = 0
        # callbacks invoked with the old->new frame-id map after a live-set rewrite;
        # wrappers holding frame ids (video/photo orchestrators) register here
        self.remap_listeners: list = []

    # ------------------------------------------------------------- surrogates ----
    def optimize_surrogates(self, tier: SurrogateTier = SurrogateTier.GIST) -> MaintenanceReport:
        """Generate/update surrogate frames for chunk/document frames
        (reference :33-157)."""
        orch = self.orch
        created = current = scanned = 0
        # index existing surrogates by source frame
        existing: dict[int, tuple[int, str]] = {}
        for fid in range(orch.store.frame_count()):
            m = orch.store.frame_meta(fid)
            if m and m.kind == FrameKind.SURROGATE.value and m.status == FrameStatus.ACTIVE.value:
                if m.parent_id is not None:
                    existing[m.parent_id] = (fid, m.metadata.get("source_sha", ""))

        for fid in range(orch.store.frame_count()):
            m = orch.store.frame_meta(fid)
            if m is None or m.status != FrameStatus.ACTIVE.value or m.superseded_by is not None:
                continue
            if m.kind not in (FrameKind.CHUNK.value, FrameKind.DOCUMENT.value):
                continue
            scanned += 1
            raw = orch.store.frame_content(fid) or b""
            source_sha = hashlib.sha256(raw).hexdigest()[:16]
            prev = existing.get(fid)
            if prev is not None and prev[1] == source_sha:
                current += 1
                continue
            surr = generate_surrogate(raw.decode("utf-8", errors="ignore"), tier, orch.counter)
            if not surr.text:
                continue
            meta = {
                "source_sha": source_sha,
                "algo": SURROGATE_ALGO,
                "tier": tier.value,
            }
            if prev is not None:
                orch.store.supersede(
                    prev[0], surr.text, kind=FrameKind.SURROGATE.value, parent_id=fid, metadata=meta
                )
            else:
                orch.store.put(
                    surr.text, kind=FrameKind.SURROGATE.value, parent_id=fid, metadata=meta
                )
            created += 1
        return MaintenanceReport(created, current, scanned)

    # --------------------------------------------------------------- compaction ----
    def compact_indexes(self) -> int:
        """Drop tombstones from the lexical postings and rebuild the vector engine
        without dead rows, then commit (reference :160-171)."""
        orch = self.orch
        orch.engine.lex.compact()
        _drop_lex_snapshots(orch.engine)
        vec = orch.engine.vector
        if isinstance(vec.builder, DenseIndexBuilder):
            b = vec.builder
            state = b.state_arrays()
            live = state["active"]
            fresh = DenseIndexBuilder(dim=b.dim, similarity=b.similarity)
            if live.any():
                fresh.add_batch(state["frame_ids"][live], state["emb"][live])
            vec.builder = fresh
            _reset_vector_snapshot(vec)
        return orch.flush()

    # ---------------------------------------------------------- live-set rewrite ----
    def dead_bytes(self) -> int:
        """Estimate reclaimable bytes: payloads of dead frames + superseded segment
        blobs left behind by earlier commits."""
        store = self.orch.store
        dead = 0
        for fid in range(store.frame_count()):
            m = store.frame_meta(fid)
            rec = store._frame_record(fid)
            if rec is None:
                continue
            if m.status == FrameStatus.DELETED.value or m.superseded_by is not None:
                dead += rec[2]
        current_offsets = {man.offset for man in store.toc.manifests.values()}
        for seg in store.toc.segment_catalog:
            if seg.offset not in current_offsets:
                dead += seg.length
        return dead

    def rewrite_live_set(self) -> LiveSetRewriteReport:
        """Copy live frames into a fresh file (dropping dead payloads and stale
        segments), remap dense frame ids, verify, and atomically swap
        (reference :176-289)."""
        t0 = time.perf_counter()
        orch = self.orch
        store = orch.store
        frames_before = store.frame_count()
        bytes_before = store.fd.size()

        # survivors in id order -> new dense ids
        survivors: list[int] = []
        for fid in range(frames_before):
            m = store.frame_meta(fid)
            if m is None or m.status == FrameStatus.DELETED.value:
                continue
            survivors.append(fid)
        remap = {old: new for new, old in enumerate(survivors)}

        tmp_path = Path(str(orch.path) + ".rewrite")
        if tmp_path.exists():
            os.unlink(tmp_path)
        new_store = WaxStore.create(tmp_path, orch.config.store)
        try:
            for old_fid in survivors:
                m = store.frame_meta(old_fid)
                content = store.frame_content(old_fid) or b""
                new_store.put(
                    content,
                    timestamp_ms=m.timestamp_ms,
                    kind=m.kind,
                    search_text=m.search_text,
                    metadata=dict(m.metadata),
                    tags=m.tags,
                    parent_id=remap.get(m.parent_id) if m.parent_id is not None else None,
                    chunk_index=m.chunk_index,
                    chunk_count=m.chunk_count,
                    supersedes=remap.get(m.supersedes) if m.supersedes is not None else None,
                    superseded_by=remap.get(m.superseded_by) if m.superseded_by is not None else None,
                )
            new_store.commit(allow_pending_embeddings=True)
            report_ok = new_store.verify(deep=True)["ok"]
            if not report_ok:
                raise RuntimeError("rewritten store failed verification")
        except Exception:
            new_store.close()
            if tmp_path.exists():
                os.unlink(tmp_path)
            raise

        # remap in-memory state BEFORE swapping files
        self._remap_engines(remap)
        new_store.close()
        store.close()
        os.replace(tmp_path, orch.path)
        leftover = Path(str(tmp_path) + ".lock")
        if leftover.exists():
            os.unlink(leftover)
        orch.store = WaxStore.open(orch.path, orch.config.store)
        orch.engine.frames.store = orch.store
        orch.flush()  # persist remapped indexes + stats into the fresh file

        return LiveSetRewriteReport(
            executed=True,
            reason="requested",
            frames_before=frames_before,
            frames_after=orch.store.frame_count(),
            bytes_before=bytes_before,
            bytes_after=orch.store.fd.size(),
            elapsed_ms=(time.perf_counter() - t0) * 1e3,
        )

    def _remap_engines(self, remap: dict[int, int]) -> None:
        orch = self.orch
        # lexical: rebuild from surviving analyzed docs
        orch.engine.lex = orch.engine.lex.remapped(remap)
        _drop_lex_snapshots(orch.engine)

        # vector engine: re-add surviving vectors under new ids. Branch on the
        # BUILDER type, not engine.kind: flat/auto/ivf all wrap a DenseIndexBuilder
        # (the auto router and IVF rebuild their routing / buckets from the fresh
        # builder), only HNSW carries a graph builder.
        vec = orch.engine.vector
        state = vec.builder.state_arrays()
        if isinstance(vec.builder, DenseIndexBuilder):
            fresh_v = DenseIndexBuilder(dim=vec.builder.dim, similarity=vec.builder.similarity)
            for fid, emb, active in zip(state["frame_ids"], state["emb"], state["active"]):
                if active and fid in remap:
                    fresh_v.add(remap[int(fid)], emb)
            vec.builder = fresh_v
        else:
            # the JAX rebuild passes dim, m and ef_construction only: the builder's
            # other options (extend_candidates, seed, normalize) take their defaults
            fresh_g = type(vec.builder)(
                dim=vec.builder.dim, m=vec.builder.m, ef_construction=vec.builder.ef_construction
            )
            for fid, emb, active in zip(state["frame_ids"], state["vecs"], state["active"]):
                if active and int(fid) in remap:
                    fresh_g.add(remap[int(fid)], emb)
            vec.builder = fresh_g
        _reset_vector_snapshot(vec)

        # access stats
        fresh_stats = AccessStats()
        for fid, count in orch.access_stats._counts.items():
            if fid in remap:
                fresh_stats._counts[remap[fid]] = count
                last = orch.access_stats._last_ms.get(fid)
                if last is not None:
                    fresh_stats._last_ms[remap[fid]] = last
        orch.access_stats = fresh_stats
        orch.rag_builder.access_stats = fresh_stats
        orch._access_stats_frame = None

        # structured evidence rows
        if orch.structured is not None:
            rows = orch.structured.conn.execute("SELECT fact_id, frame_id FROM sm_evidence").fetchall()
            orch.structured.conn.execute("DELETE FROM sm_evidence")
            for fact_id, fid in rows:
                if fid in remap:
                    orch.structured.conn.execute(
                        "INSERT OR IGNORE INTO sm_evidence (fact_id, frame_id) VALUES (?,?)",
                        (fact_id, remap[fid]),
                    )
            orch.structured.conn.commit()

        for listener in self.remap_listeners:
            listener(remap)

    # ------------------------------------------------------------- scheduling ----
    def note_flush(self) -> None:
        self._flushes_since_rewrite += 1

    def maybe_scheduled_rewrite(self) -> LiveSetRewriteReport:
        """Run the rewrite when the configured gates pass (reference :289-380)."""
        sched = self.orch.config.rewrite_schedule
        if not sched.enabled:
            return LiveSetRewriteReport(False, "disabled")
        if self._flushes_since_rewrite < sched.min_flush_count:
            return LiveSetRewriteReport(False, "flush-count gate")
        if now_ms() - self._last_rewrite_ms < sched.min_interval_ms:
            return LiveSetRewriteReport(False, "interval gate")
        if self.dead_bytes() < sched.min_dead_bytes:
            return LiveSetRewriteReport(False, "dead-bytes gate")
        report = self.rewrite_live_set()
        self._last_rewrite_ms = now_ms()
        self._flushes_since_rewrite = 0
        return report
