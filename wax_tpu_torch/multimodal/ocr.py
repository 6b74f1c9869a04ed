# Verbatim copy of wax_tpu/multimodal/ocr.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Default OCR provider: adapter over a local `tesseract` binary.

The reference ships VisionOCRProvider on Apple Vision (reference:
Sources/Wax/PhotoRAG/VisionOCRProvider.swift — per-block text + normalized bboxes +
confidence). There is no OS vision stack in this environment, so the practical
Linux-host default is Tesseract: this adapter shells out to the binary, parses its
TSV output (word level), groups words into line blocks, and emits `OCRBlock`s with
normalized bboxes and mean word confidence — the exact shape PhotoRAGOrchestrator
consumes. Degrades cleanly: `CommandOCRProvider.available()` is False when the
binary is missing, and any subprocess/parse failure yields [] (photos still ingest
caption/embedding-only).

ndarray inputs are written as PNM (pure numpy, no imaging dependency); `bytes` and
path inputs pass through untouched (tesseract reads PNG/JPEG natively).
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from wax_tpu_torch.multimodal.protocols import OCRBlock

__all__ = ["CommandOCRProvider", "write_pnm"]


def write_pnm(image: np.ndarray, path: str | Path) -> tuple[int, int]:
    """Write an (H, W) or (H, W, 3) uint8 array as binary PGM/PPM. Returns (h, w)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        scale = 255.0 / (hi - lo) if hi > lo else 1.0
        img = ((img - lo) * scale).astype(np.uint8)
    if img.ndim == 2:
        magic, body = b"P5", img.tobytes()
    elif img.ndim == 3 and img.shape[2] == 3:
        magic, body = b"P6", img.tobytes()
    elif img.ndim == 3 and img.shape[2] == 1:
        magic, body = b"P5", img[..., 0].tobytes()
    else:
        raise ValueError(f"unsupported image shape {img.shape}")
    h, w = img.shape[0], img.shape[1]
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(body)
    return h, w


class CommandOCRProvider:
    """OCRProvider backed by the `tesseract` CLI (TSV output, word level 5)."""

    def __init__(
        self,
        binary: str = "tesseract",
        lang: str = "eng",
        psm: int = 6,
        min_confidence: float = 0.0,
        timeout_s: float = 60.0,
    ):
        self.binary = binary
        self.lang = lang
        self.psm = psm
        self.min_confidence = min_confidence
        self.timeout_s = timeout_s

    @classmethod
    def available(cls, binary: str = "tesseract") -> bool:
        return shutil.which(binary) is not None

    # ---------------------------------------------------------------------- ocr ----
    def ocr(self, image) -> list[OCRBlock]:
        tmp = None
        try:
            if isinstance(image, np.ndarray):
                fd, tmp = tempfile.mkstemp(suffix=".pnm")
                os.close(fd)
                h, w = write_pnm(image, tmp)
                path = tmp
            elif isinstance(image, (bytes, bytearray)):
                fd, tmp = tempfile.mkstemp(suffix=".img")
                os.close(fd)
                Path(tmp).write_bytes(bytes(image))
                path, h, w = tmp, 0, 0
            else:
                path, h, w = str(image), 0, 0
            out = subprocess.run(
                [self.binary, path, "stdout", "-l", self.lang, "--psm", str(self.psm), "tsv"],
                capture_output=True,
                timeout=self.timeout_s,
                check=False,
            )
            if out.returncode != 0:
                return []
            return self._parse_tsv(out.stdout.decode("utf-8", errors="replace"), h, w)
        except Exception:  # noqa: BLE001 — OCR is best-effort by contract
            return []
        finally:
            if tmp is not None:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def _parse_tsv(self, tsv: str, img_h: int, img_w: int) -> list[OCRBlock]:
        """Group word rows (level 5) by (block, paragraph, line) into line blocks."""
        lines: dict[tuple, dict] = {}
        header: list[str] | None = None
        for row in tsv.splitlines():
            cols = row.split("\t")
            if header is None:
                header = cols
                idx = {name: i for i, name in enumerate(cols)}
                need = ("level", "block_num", "par_num", "line_num", "left", "top",
                        "width", "height", "conf", "text")
                if not all(n in idx for n in need):
                    return []
                continue
            if len(cols) < len(header):
                continue
            try:
                if int(cols[idx["level"]]) != 5:
                    continue
                conf = float(cols[idx["conf"]])
                text = cols[idx["text"]].strip()
                if not text or conf < 0:
                    continue
                left, top = int(cols[idx["left"]]), int(cols[idx["top"]])
                width, height = int(cols[idx["width"]]), int(cols[idx["height"]])
            except (ValueError, KeyError):
                continue
            try:
                # int keys: string keys would order line 10 before line 2
                key = (
                    int(cols[idx["block_num"]]),
                    int(cols[idx["par_num"]]),
                    int(cols[idx["line_num"]]),
                )
            except ValueError:
                continue
            entry = lines.setdefault(
                key, {"words": [], "confs": [], "x0": left, "y0": top, "x1": left, "y1": top}
            )
            entry["words"].append(text)
            entry["confs"].append(conf)
            entry["x0"] = min(entry["x0"], left)
            entry["y0"] = min(entry["y0"], top)
            entry["x1"] = max(entry["x1"], left + width)
            entry["y1"] = max(entry["y1"], top + height)
        # normalize: use image dims when known, else the max extent seen
        max_x = img_w or max((e["x1"] for e in lines.values()), default=1) or 1
        max_y = img_h or max((e["y1"] for e in lines.values()), default=1) or 1
        blocks: list[OCRBlock] = []
        for key in sorted(lines):
            e = lines[key]
            conf = sum(e["confs"]) / (100.0 * max(1, len(e["confs"])))
            if conf < self.min_confidence:
                continue
            blocks.append(
                OCRBlock(
                    text=" ".join(e["words"]),
                    bbox=(
                        e["x0"] / max_x,
                        e["y0"] / max_y,
                        (e["x1"] - e["x0"]) / max_x,
                        (e["y1"] - e["y0"]) / max_y,
                    ),
                    confidence=conf,
                )
            )
        return blocks
