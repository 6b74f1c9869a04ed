# Copy of wax_tpu/surfaces/mcp_server.py with these changes: `build_server(store_path,
# device)` passes `device` (None: the current CUDA device, or every visible one with
# WAX_TPU_SHARDED_LANES=1; "cpu" or a sequence of devices on request) to the orchestrator,
# and the lead device to the embedder and the photo/video orchestrators; no XLA compile
# cache (`warmup` builds the kernels); `_select_embedder` hands the checkpoint directory
# it finds to the port's MiniLMEmbedder, which reads no environment. Keep the two in step.
"""MCP server: newline-delimited JSON-RPC 2.0 over stdio exposing wax_* tools.

Mirrors the reference's WaxMCPServer (reference: Sources/WaxMCPServer/ —
ToolSchemas.swift:13-107 tools wax_remember/recall/search/flush/stats/session_start/
session_end/handoff/handoff_latest + structured wax_entity_upsert/fact_assert/
fact_retract/facts_query/entity_resolve; main.swift:21-78 — store path resolution under
~/.wax, env feature flags). Python stdlib only; the orchestrator does the work.

Env flags (reference parity: WAX_MCP_FEATURE_*):
  WAX_TPU_FEATURE_STRUCTURED_MEMORY=0 disables the structured tools,
  WAX_TPU_FEATURE_ACCESS_STATS=0 disables access stats,
  WAX_TPU_STORE overrides the store path (default ~/.wax-tpu/memory.wxs).

Run it with `python -m wax_tpu_torch.surfaces.mcp_server`; it serves on the current
CUDA device.
"""
from __future__ import annotations

import json
import os
import sys
import traceback
from pathlib import Path

import torch

from wax_tpu_torch.orchestrator.config import OrchestratorConfig
from wax_tpu_torch.orchestrator.orchestrator import MemoryOrchestrator
from wax_tpu_torch.structured.memory import FactValue
from wax_tpu_torch.types import SearchMode, SearchRequest, TimeRange
from wax_tpu_torch.utils.device import resolve_device, resolve_devices
from wax_tpu_torch.version import __version__

PROTOCOL_VERSION = "2024-11-05"

_TOOLS: list[dict] = [
    {
        "name": "wax_remember",
        "description": "Store a memory (text). Returns frame ids.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "content": {"type": "string"},
                "metadata": {"type": "object", "additionalProperties": {"type": "string"}},
                "tags": {"type": "array", "items": {"type": "string"}},
            },
            "required": ["content"],
        },
    },
    {
        "name": "wax_recall",
        "description": "Retrieve a token-budgeted RAG context for a query.",
        "inputSchema": {
            "type": "object",
            "properties": {"query": {"type": "string"}, "top_k": {"type": "integer"}},
            "required": ["query"],
        },
    },
    {
        "name": "wax_search",
        "description": "Hybrid search (BM25 + vector + structured + temporal, RRF-fused).",
        "inputSchema": {
            "type": "object",
            "properties": {
                "query": {"type": "string"},
                "top_k": {"type": "integer"},
                "mode": {"type": "string", "enum": ["hybrid", "text", "vector"]},
                "after_ms": {"type": "integer"},
                "before_ms": {"type": "integer"},
                "metadata_filter": {
                    "type": "object",
                    "additionalProperties": {"type": "string"},
                    "description": "Exact-match metadata key/value filters applied after fusion.",
                },
                "frame_ids": {
                    "type": "array",
                    "items": {"type": "integer"},
                    "description": "Restrict results to these frame ids.",
                },
                "as_of_ms": {
                    "type": "integer",
                    "description": "Bitemporal as-of for the structured-evidence lane.",
                },
                "include_diagnostics": {
                    "type": "boolean",
                    "description": "Attach per-hit lane ranks/scores, RRF score, and tie-break reason.",
                },
            },
            "required": ["query"],
        },
    },
    {
        "name": "wax_forget",
        "description": "Delete a memory frame (and its chunks).",
        "inputSchema": {
            "type": "object",
            "properties": {"frame_id": {"type": "integer"}},
            "required": ["frame_id"],
        },
    },
    {
        "name": "wax_timeline",
        "description": "Time-ordered list of stored memories.",
        "inputSchema": {
            "type": "object",
            "properties": {"limit": {"type": "integer"}},
        },
    },
    {"name": "wax_flush", "description": "Commit all pending state to disk.", "inputSchema": {"type": "object", "properties": {}}},
    {"name": "wax_stats", "description": "Runtime statistics.", "inputSchema": {"type": "object", "properties": {}}},
    {
        "name": "wax_session_start",
        "description": "Start a tagged ingest session.",
        "inputSchema": {"type": "object", "properties": {"name": {"type": "string"}}},
    },
    {"name": "wax_session_end", "description": "End the current session.", "inputSchema": {"type": "object", "properties": {}}},
    {
        "name": "wax_handoff",
        "description": "Persist an agent handoff record for the next session.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "content": {"type": "string"},
                "session_id": {"type": "string", "description": "Optional explicit session scope."},
                "project": {"type": "string", "description": "Optional project scope."},
                "pending_tasks": {"type": "array", "items": {"type": "string"}},
            },
            "required": ["content"],
        },
    },
    {
        "name": "wax_handoff_latest",
        "description": "Fetch the most recent handoff record, optionally scoped.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "session_id": {"type": "string"},
                "project": {"type": "string"},
            },
        },
    },
]

_MULTIMODAL_TOOLS: list[dict] = [
    {
        "name": "wax_video_ingest",
        "description": "Ingest a video via its host-supplied transcript spans.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "video_id": {"type": "string"},
                "duration_ms": {"type": "integer"},
                "transcript": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "properties": {
                            "start_ms": {"type": "integer"},
                            "end_ms": {"type": "integer"},
                            "text": {"type": "string"},
                        },
                        "required": ["start_ms", "end_ms", "text"],
                    },
                },
                "keyframe_refs": {"type": "array", "items": {"type": "string"}},
            },
            "required": ["video_id", "duration_ms", "transcript"],
        },
    },
    {
        "name": "wax_video_recall",
        "description": "Recall video segments matching a query.",
        "inputSchema": {
            "type": "object",
            "properties": {"query": {"type": "string"}, "top_k": {"type": "integer"}},
            "required": ["query"],
        },
    },
    {
        "name": "wax_video_forget",
        "description": "Delete an ingested video (root + segment frames).",
        "inputSchema": {
            "type": "object",
            "properties": {"video_id": {"type": "string"}},
            "required": ["video_id"],
        },
    },
    {
        "name": "wax_photo_ingest",
        "description": "Ingest a photo asset via host-supplied caption/OCR text.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "asset_id": {"type": "string"},
                "caption": {"type": "string"},
                "ocr_texts": {"type": "array", "items": {"type": "string"}},
                "taken_at_ms": {"type": "integer"},
                "gps": {"type": "array", "items": {"type": "number"}, "minItems": 2, "maxItems": 2},
                "thumbnail_ref": {"type": "string"},
            },
            "required": ["asset_id"],
        },
    },
    {
        "name": "wax_photo_forget",
        "description": "Delete an ingested photo asset (root/caption/OCR frames).",
        "inputSchema": {
            "type": "object",
            "properties": {"asset_id": {"type": "string"}},
            "required": ["asset_id"],
        },
    },
    {
        "name": "wax_photo_recall",
        "description": "Recall photos matching a query with optional time/location constraints.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "query": {"type": "string"},
                "top_k": {"type": "integer"},
                "after_ms": {"type": "integer"},
                "before_ms": {"type": "integer"},
                "near": {"type": "array", "items": {"type": "number"}, "minItems": 2, "maxItems": 2},
            },
            "required": ["query"],
        },
    },
]

_STRUCTURED_TOOLS: list[dict] = [
    {
        "name": "wax_entity_upsert",
        "description": "Create or update an entity with optional aliases.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "name": {"type": "string"},
                "kind": {"type": "string"},
                "aliases": {"type": "array", "items": {"type": "string"}},
            },
            "required": ["name"],
        },
    },
    {
        "name": "wax_entity_resolve",
        "description": "Resolve an entity id by name or alias.",
        "inputSchema": {
            "type": "object",
            "properties": {"name": {"type": "string"}},
            "required": ["name"],
        },
    },
    {
        "name": "wax_fact_assert",
        "description": "Assert a typed fact about an entity.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "subject": {"type": "string"},
                "predicate": {"type": "string"},
                "value": {"type": "string"},
                "value_kind": {"type": "string", "enum": ["text", "int", "real", "bool", "time"]},
                "valid_from_ms": {"type": "integer"},
                "evidence_frames": {"type": "array", "items": {"type": "integer"}},
            },
            "required": ["subject", "predicate", "value"],
        },
    },
    {
        "name": "wax_fact_retract",
        "description": "Retract (close the validity span of) a fact.",
        "inputSchema": {
            "type": "object",
            "properties": {"fact_id": {"type": "integer"}},
            "required": ["fact_id"],
        },
    },
    {
        "name": "wax_facts_query",
        "description": "Query facts by subject/predicate, optionally as-of a timestamp.",
        "inputSchema": {
            "type": "object",
            "properties": {
                "subject": {"type": "string"},
                "predicate": {"type": "string"},
                "as_of_ms": {"type": "integer"},
            },
        },
    },
]


def _parse_fact_value(value: str, kind: str) -> FactValue:
    if kind == "int":
        return FactValue.integer(int(value))
    if kind == "real":
        return FactValue.real(float(value))
    if kind == "bool":
        return FactValue.boolean(value.lower() in ("1", "true", "yes"))
    if kind == "time":
        return FactValue.time_ms(int(value))
    return FactValue.text(value)


class McpServer:
    def __init__(
        self,
        orchestrator: MemoryOrchestrator,
        structured_enabled: bool = True,
        video_store: str | Path | None = None,
        photo_store: str | Path | None = None,
    ):
        self.orch = orchestrator
        self.structured_enabled = structured_enabled and orchestrator.structured is not None
        # lazy multimodal stores (the reference runs three stores:
        # ~/.wax/{memory,video,photo}.mv2s — main.swift:21-28)
        self._video_store = Path(video_store) if video_store else self.orch.path.parent / "video.wxs"
        self._photo_store = Path(photo_store) if photo_store else self.orch.path.parent / "photo.wxs"
        self._video = None
        self._photo = None
        # readiness gate: the FIRST tools/call waits (bounded) for the background
        # warmup so it never races the lane pre-trace for the compile — the first
        # agent call lands at steady-state latency. initialize/tools/list answer
        # immediately while warming. 0 disables the gate.
        self._warmup_timeout = float(os.environ.get("WAX_TPU_WARMUP_TIMEOUT", "120"))
        self._warm_gated = False

    def _video_rag(self):
        if self._video is None:
            from wax_tpu_torch.multimodal.video import VideoRAGOrchestrator

            self._video = VideoRAGOrchestrator(self._video_store, device=self.orch.device)
        return self._video

    def _photo_rag(self):
        if self._photo is None:
            from wax_tpu_torch.embed.hash_embedder import HashEmbedder
            from wax_tpu_torch.multimodal.photo import PhotoRAGOrchestrator

            class _TextSpaceEmbedder:
                """Joint-space embedder over text inputs (MCP ships text, not pixels)."""

                def __init__(self):
                    self._h = HashEmbedder(384)

                dimensions = 384
                identity = "mcp-text-space"

                def embed_text(self, text):
                    return self._h.embed(text)

                def embed_image(self, image):
                    return self._h.embed(f"image:{image}")

            from wax_tpu_torch.multimodal.ocr import CommandOCRProvider

            # tesseract-backed OCR when the binary is on PATH (the Linux-host
            # analogue of the reference's in-OS VisionOCRProvider); hosts usually
            # pass ocr_texts explicitly over MCP, this covers raw-image ingest
            ocr = CommandOCRProvider() if CommandOCRProvider.available() else None
            self._photo = PhotoRAGOrchestrator(
                self._photo_store, embedder=_TextSpaceEmbedder(), ocr_provider=ocr, device=self.orch.device
            )
        return self._photo

    # ------------------------------------------------------------------ dispatch ----
    def tools(self) -> list[dict]:
        tools = list(_TOOLS) + list(_MULTIMODAL_TOOLS)
        if self.structured_enabled:
            tools += _STRUCTURED_TOOLS
        return tools

    def call_tool(self, name: str, args: dict) -> dict:
        if not self.structured_enabled and any(t["name"] == name for t in _STRUCTURED_TOOLS):
            # tools hidden from tools/list must also refuse dispatch with a clear
            # reason, not fail deep inside on orch.structured being None
            raise ValueError(f"tool {name} is disabled (structured memory feature off)")
        handler = getattr(self, f"_tool_{name}", None)
        if handler is None:
            raise ValueError(f"unknown tool {name}")
        return handler(args)

    # -------------------------------------------------------------------- handlers ----
    def _tool_wax_remember(self, a):
        res = self.orch.remember(a["content"], a.get("metadata"), tuple(a.get("tags", ())))
        return {"document_id": res.document_id, "chunk_ids": list(res.chunk_ids)}

    def _tool_wax_recall(self, a):
        ctx = self.orch.recall(a["query"], a.get("top_k"))
        return {
            "context": ctx.render(),
            "total_tokens": ctx.total_tokens,
            "items": [
                {"kind": i.kind.value, "frame_id": i.frame_id, "score": i.score, "text": i.text}
                for i in ctx.items
            ],
        }

    def _tool_wax_search(self, a):
        mode = {"hybrid": SearchMode.HYBRID, "text": SearchMode.TEXT_ONLY, "vector": SearchMode.VECTOR_ONLY}[
            a.get("mode", "hybrid")
        ]
        tr = None
        if a.get("after_ms") is not None or a.get("before_ms") is not None:
            tr = TimeRange(a.get("after_ms"), a.get("before_ms"))
        req = SearchRequest(
            query=a["query"],
            top_k=a.get("top_k", 10),
            mode=mode,
            time_range=tr,
            metadata_filter=a.get("metadata_filter"),
            frame_filter=frozenset(a["frame_ids"]) if a.get("frame_ids") else None,
            as_of_ms=a.get("as_of_ms"),
            include_diagnostics=bool(a.get("include_diagnostics", False)),
        )
        resp = self.orch.search(req)
        hits = []
        for h in resp.hits:
            row = {
                "frame_id": h.frame_id,
                "score": h.score,
                "preview": h.preview,
                "sources": [s.value for s in h.sources],
            }
            if h.diagnostics is not None:
                row["diagnostics"] = {
                    "lane_ranks": dict(h.diagnostics.lane_ranks),
                    "lane_scores": dict(h.diagnostics.lane_scores),
                    "rrf_score": h.diagnostics.rrf_score,
                    "tie_break": h.diagnostics.tie_break,
                }
            hits.append(row)
        out = {"query_type": resp.query_type.value, "hits": hits}
        if resp.warnings:
            # silent-recall-loss configurations (e.g. AND query under a manual
            # postings budget below the auto floor) surface here unconditionally
            out["warnings"] = list(resp.warnings)
        if a.get("include_diagnostics"):
            out["lane_counts"] = dict(resp.lane_counts)
        return out

    def _tool_wax_forget(self, a):
        return {"deleted": self.orch.forget(int(a["frame_id"]))}

    def _tool_wax_timeline(self, a):
        metas = self.orch.timeline(limit=a.get("limit", 50))
        return {
            "frames": [
                {"frame_id": m.frame_id, "timestamp_ms": m.timestamp_ms, "kind": m.kind}
                for m in metas
            ]
        }

    def _tool_wax_flush(self, a):
        return {"generation": self.orch.flush()}

    def _tool_wax_stats(self, a):
        return self.orch.runtime_stats()

    def _tool_wax_session_start(self, a):
        return {"session_id": self.orch.session_start(a.get("name"))}

    def _tool_wax_session_end(self, a):
        self.orch.session_end()
        return {"ok": True}

    def _tool_wax_handoff(self, a):
        return {
            "frame_id": self.orch.handoff(
                a["content"],
                session_id=a.get("session_id"),
                project=a.get("project"),
                pending_tasks=tuple(a.get("pending_tasks", ())),
            )
        }

    def _tool_wax_handoff_latest(self, a):
        got = self.orch.handoff_latest(
            session_id=a.get("session_id"), project=a.get("project")
        )
        if got is None:
            return {"found": False}
        meta, content = got
        return {"found": True, "frame_id": meta.frame_id, "timestamp_ms": meta.timestamp_ms, "content": content}

    def _tool_wax_video_ingest(self, a):
        from wax_tpu_torch.multimodal.protocols import TranscriptSpan

        spans = [TranscriptSpan(s["start_ms"], s["end_ms"], s["text"]) for s in a["transcript"]]

        class _Inline:
            def transcript(self, ref):
                return spans

        res = self._video_rag().ingest(
            a["video_id"], int(a["duration_ms"]), _Inline(), a.get("keyframe_refs")
        )
        return {
            "root_frame": res.root_frame,
            "segment_frames": list(res.segment_frames),
            "skipped_duplicate": res.skipped_duplicate,
        }

    def _tool_wax_video_recall(self, a):
        ctx = self._video_rag().recall_context(a["query"], a.get("top_k", 8))
        hits = [s for item in ctx.items for s in item.segments]
        hits.sort(key=lambda s: (-s.score, s.frame_id))
        return {
            "hits": [
                {
                    "video_id": h.video_id,
                    "segment_index": h.segment_index,
                    "start_ms": h.start_ms,
                    "end_ms": h.end_ms,
                    "score": h.score,
                    "text": h.text,
                    "keyframe_ref": h.keyframe_ref,
                    "evidence": list(h.evidence),
                }
                for h in hits[: a.get("top_k", 8)]
            ],
            "items": [
                {
                    "video_id": i.video_id,
                    "score": i.score,
                    "evidence": list(i.evidence),
                    "summary": i.summary,
                    "segments": [s.segment_index for s in i.segments],
                }
                for i in ctx.items
            ],
            "used_text_tokens": ctx.used_text_tokens,
        }

    def _tool_wax_video_forget(self, a):
        return {"deleted": self._video_rag().forget(a["video_id"])}

    def _tool_wax_photo_forget(self, a):
        return {"deleted": self._photo_rag().forget(a["asset_id"])}

    def _tool_wax_photo_ingest(self, a):
        gps = tuple(a["gps"]) if a.get("gps") else None
        res = self._photo_rag().ingest(
            a["asset_id"],
            image=a.get("thumbnail_ref", a["asset_id"]),
            taken_at_ms=a.get("taken_at_ms"),
            gps=gps,
            thumbnail_ref=a.get("thumbnail_ref"),
            caption_text=a.get("caption"),
            ocr_texts=a.get("ocr_texts"),
        )
        return {
            "root_frame": res.root_frame,
            "caption_frame": res.caption_frame,
            "ocr_frames": list(res.ocr_frames),
            "skipped_duplicate": res.skipped_duplicate,
        }

    def _tool_wax_photo_recall(self, a):
        from wax_tpu_torch.types import TimeRange

        tr = None
        if a.get("after_ms") is not None or a.get("before_ms") is not None:
            tr = TimeRange(a.get("after_ms"), a.get("before_ms"))
        near = tuple(a["near"]) if a.get("near") else None
        ctx = self._photo_rag().recall_context(
            a["query"], a.get("top_k", 8), time_range=tr, near=near
        )
        return {
            "hits": [
                {
                    "asset_id": h.asset_id,
                    "score": h.score,
                    "kind": h.kind,
                    "text": h.text,
                    "taken_at_ms": h.taken_at_ms,
                    "gps": h.gps,
                    "thumbnail_ref": h.thumbnail_ref,
                    "summary": h.summary,
                    "evidence": list(h.evidence),
                    "regions": [
                        {"bbox": list(r.bbox), "type": r.region_type, "crop_ref": r.crop_ref}
                        for r in h.regions
                    ],
                }
                for h in ctx.items
            ],
            "used_text_tokens": ctx.used_text_tokens,
        }

    def _tool_wax_entity_upsert(self, a):
        self._check_structured()
        return {"entity_id": self.orch.entity_upsert(a["name"], a.get("kind"), a.get("aliases", ()))}

    def _tool_wax_entity_resolve(self, a):
        self._check_structured()
        return {"entity_id": self.orch.entity_resolve(a["name"])}

    def _tool_wax_fact_assert(self, a):
        self._check_structured()
        value = _parse_fact_value(a["value"], a.get("value_kind", "text"))
        fid = self.orch.fact_assert(
            a["subject"], a["predicate"], value, a.get("valid_from_ms"), a.get("evidence_frames", ())
        )
        return {"fact_id": fid}

    def _tool_wax_fact_retract(self, a):
        self._check_structured()
        return {"retracted": self.orch.fact_retract(int(a["fact_id"]))}

    def _tool_wax_facts_query(self, a):
        self._check_structured()
        rows = self.orch.facts_query(a.get("subject"), a.get("predicate"), a.get("as_of_ms"))
        return {
            "facts": [
                {
                    "fact_id": r.fact_id,
                    "subject": r.subject,
                    "predicate": r.predicate,
                    "value": str(r.value.value),
                    "value_kind": r.value.kind,
                    "valid_from_ms": r.valid_from_ms,
                    "valid_to_ms": r.valid_to_ms,
                    "evidence_frames": list(r.evidence_frames),
                }
                for r in rows
            ]
        }

    def _check_structured(self):
        if not self.structured_enabled:
            raise ValueError("structured memory tools disabled")

    # ----------------------------------------------------------------------- rpc ----
    def handle(self, msg: dict) -> dict | None:
        mid = msg.get("id")
        method = msg.get("method", "")
        try:
            if method == "initialize":
                result = {
                    "protocolVersion": PROTOCOL_VERSION,
                    "capabilities": {"tools": {}},
                    "serverInfo": {"name": "wax-tpu", "version": __version__},
                }
            elif method == "notifications/initialized":
                return None
            elif method == "tools/list":
                result = {"tools": self.tools()}
            elif method == "tools/call":
                if not self._warm_gated:
                    self._warm_gated = True
                    if self._warmup_timeout > 0:
                        self.orch.wait_for_warmup(timeout=self._warmup_timeout)
                name = msg["params"]["name"]
                args = msg["params"].get("arguments", {})
                out = self.call_tool(name, args)
                result = {"content": [{"type": "text", "text": json.dumps(out)}]}
            elif method == "ping":
                result = {}
            else:
                if mid is None:
                    return None
                return {
                    "jsonrpc": "2.0",
                    "id": mid,
                    "error": {"code": -32601, "message": f"method not found: {method}"},
                }
            if mid is None:
                return None
            return {"jsonrpc": "2.0", "id": mid, "result": result}
        except Exception as e:  # noqa: BLE001
            if mid is None:
                return None
            return {
                "jsonrpc": "2.0",
                "id": mid,
                "error": {"code": -32603, "message": f"{type(e).__name__}: {e}"},
            }

    def close(self) -> None:
        for sub in (self._video, self._photo):
            if sub is not None:
                try:
                    sub.flush()
                except Exception:  # noqa: BLE001
                    pass
                sub.close()
        self.orch.close()

    def serve_stdio(self, stdin=None, stdout=None) -> None:
        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        for line in stdin:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            resp = self.handle(msg)
            if resp is not None:
                stdout.write(json.dumps(resp) + "\n")
                stdout.flush()


def default_store_path() -> Path:
    return Path(os.environ.get("WAX_TPU_STORE", str(Path.home() / ".wax-tpu" / "memory.wxs")))


def build_server(store_path: str | Path | None = None, device=None) -> McpServer:
    sharded = os.environ.get("WAX_TPU_SHARDED_LANES", "0") == "1"
    if sharded or not (device is None or isinstance(device, (str, torch.device))):
        device = resolve_devices(device)  # the mesh's devices; the orchestrator checks the config
        lead = device[0]
    else:
        device = lead = resolve_device(device)
    _check_license()
    structured = os.environ.get("WAX_TPU_FEATURE_STRUCTURED_MEMORY", "1") != "0"
    access = os.environ.get("WAX_TPU_FEATURE_ACCESS_STATS", "1") != "0"
    path = Path(store_path) if store_path else default_store_path()
    path.parent.mkdir(parents=True, exist_ok=True)
    # scale knobs for serving deployments: distribute the dense + BM25 lanes over
    # all local devices (WAX_TPU_SHARDED_LANES=1), optionally on a two-level
    # slice x data[x tp] mesh (WAX_TPU_MESH_SLICES / WAX_TPU_MESH_TP), and bound
    # device BM25 work on 1M+ corpora (WAX_TPU_POSTINGS_BUDGET=auto|N; candidate
    # truncation only — returned scores stay exact via the forward-index rescore).
    budget_raw = os.environ.get("WAX_TPU_POSTINGS_BUDGET", "")
    budget: int | str | None = None
    if budget_raw:
        budget = "auto" if budget_raw.lower() == "auto" else int(budget_raw)
    cfg = OrchestratorConfig(
        enable_structured_memory=structured,
        enable_access_stats=access,
        sharded_lanes=sharded,
        mesh_slices=int(os.environ.get("WAX_TPU_MESH_SLICES", "1")) if sharded else 1,
        mesh_tp=int(os.environ.get("WAX_TPU_MESH_TP", "1")) if sharded else 1,
        lex_postings_budget=budget,
        # migration escape hatch for an intentional embedder change on an existing
        # store: WAX_TPU_EMBEDDER_MISMATCH=reindex re-embeds, =ignore keeps stale
        embedder_mismatch=os.environ.get("WAX_TPU_EMBEDDER_MISMATCH", "error"),
    )
    orch = MemoryOrchestrator(path, _select_embedder(path, lead), config=cfg, device=device)
    # build and launch the search lanes' kernels in the idle gap before the first
    # tool call, so the first query pays neither the nvcc build nor the first launch
    orch.warmup(background=True)
    return McpServer(orch, structured_enabled=structured)


def _check_license() -> None:
    """Offline HMAC license gate (reference: WaxMCPServer/LicenseValidator.swift:52;
    DISABLED by default per the reference's docs). When WAX_TPU_FEATURE_LICENSE=1,
    the token in WAX_TPU_LICENSE must validate against WAX_TPU_LICENSE_SECRET or the
    server refuses to build."""
    from wax_tpu_torch.surfaces.license import license_required, validate_license

    if not license_required():
        return
    token = os.environ.get("WAX_TPU_LICENSE", "")
    secret = os.environ.get("WAX_TPU_LICENSE_SECRET", "")
    info = validate_license(token, secret)
    if not info.valid:
        raise PermissionError(f"license check failed: {info.reason or 'missing token'}")
    print(f"[wax-tpu] licensed to {info.licensee}", file=sys.stderr, flush=True)


def _stored_embedder_identity(path: Path) -> str | None:
    """Peek at an existing store's committed vec-segment embedder identity without
    taking the writer lease (readonly shared open, closed immediately)."""
    try:
        from wax_tpu_torch.storage.store import WaxStore

        if not path.exists() or path.stat().st_size == 0:
            return None
        store = WaxStore.open(path, readonly=True)
        try:
            man = store.toc.manifests.get("vec")
            return (man.attrs or {}).get("embedder") if man is not None else None
        finally:
            store.close()
    except Exception:  # noqa: BLE001 — peek is best-effort
        return None


def _select_embedder(store_path: Path | None = None, device=None):
    """MCP embedder selection with loud provenance logging (stderr — stdout is the
    JSON-RPC channel). Env WAX_TPU_EMBEDDER: "auto" (default), "minilm" (force —
    warns LOUDLY if weights are missing and it would serve random-init embeddings),
    or "hash". "auto" respects an EXISTING store's embedder first — a store built
    with the hash embedder keeps working after the user fetches MiniLM weights
    (switching providers on existing vectors trips the embedder-mismatch guard and
    would otherwise brick the server at startup); it logs the migration path
    instead. The reference ships its MiniLM weights in-package; this environment
    has no egress, so the fetch step is explicit (scripts/fetch_minilm.py)."""
    import sys

    choice = os.environ.get("WAX_TPU_EMBEDDER", "auto").lower()
    log = lambda msg: print(f"[wax-tpu] {msg}", file=sys.stderr, flush=True)

    def minilm_dir():
        env = os.environ.get("WAX_TPU_MINILM_DIR")
        if env and Path(env).exists():
            return Path(env)
        default = Path.home() / ".wax-tpu" / "models" / "all-MiniLM-L6-v2"
        return default if default.exists() else None

    if choice == "hash":
        from wax_tpu_torch.embed.hash_embedder import HashEmbedder

        log("embedder: deterministic hash (WAX_TPU_EMBEDDER=hash)")
        return HashEmbedder(384)
    ckpt = minilm_dir()
    if choice == "auto" and store_path is not None:
        stored = _stored_embedder_identity(Path(store_path))
        if stored and stored.startswith("hash-embedder"):
            from wax_tpu_torch.embed.hash_embedder import HashEmbedder

            extra = (
                " MiniLM weights are available — to migrate this store set "
                "WAX_TPU_EMBEDDER=minilm WAX_TPU_EMBEDDER_MISMATCH=reindex once "
                "(re-embeds all content)."
                if ckpt is not None
                else ""
            )
            log(f"embedder: deterministic hash (matching the existing store).{extra}")
            return HashEmbedder(384)
    if choice == "minilm" or (choice == "auto" and ckpt is not None):
        from wax_tpu_torch.embed.minilm import MiniLMEmbedder

        emb = MiniLMEmbedder(checkpoint_dir=ckpt, device=device)
        if ckpt is None:
            log(
                "WARNING: embedder: MiniLM with RANDOM-INIT weights — semantic search "
                "quality will be garbage. Fetch real weights with "
                "`python scripts/fetch_minilm.py` (or set WAX_TPU_MINILM_DIR), or set "
                "WAX_TPU_EMBEDDER=hash for the deterministic fallback."
            )
        else:
            log(f"embedder: MiniLM-L6 (weights: {ckpt})")
        return emb
    from wax_tpu_torch.embed.hash_embedder import HashEmbedder

    log(
        "embedder: deterministic hash (no MiniLM weights found — run "
        "`python scripts/fetch_minilm.py` to enable real semantic embeddings, "
        "then restart; set WAX_TPU_EMBEDDER=minilm to force)"
    )
    return HashEmbedder(384)


def main() -> None:
    server = build_server()
    try:
        server.serve_stdio()
    except KeyboardInterrupt:
        pass
    except Exception:  # noqa: BLE001
        traceback.print_exc(file=sys.stderr)
    finally:
        try:
            server.orch.flush()
        except Exception:  # noqa: BLE001
            pass
        server.close()


if __name__ == "__main__":
    main()
