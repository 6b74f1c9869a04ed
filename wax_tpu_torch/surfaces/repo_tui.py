# Verbatim copy of wax_tpu/surfaces/repo_tui.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Interactive terminal UI for WaxRepo ("Sift") — live semantic git-history search.

The TPU-build analogue of the reference's SwiftTUI app (reference:
Sources/WaxRepo/Views/ + ViewModels/ + main.swift:7-14 — a query box with
search-as-you-type, a result list, and a commit preview pane). Split MVVM-style so
the view-model is headless-testable:

  * RepoTuiModel — query state, debounced search over RepoIndexer, selection,
    preview resolution (the ViewModel).
  * run_tui(indexer, screen=None) — a curses event loop rendering query line +
    result list + preview pane; `screen` is injectable so tests drive the loop
    with a fake screen (no terminal needed).

Keys: type to search, Up/Down select, PgUp/PgDn scroll preview, Esc/Ctrl-C quit.
"""
from __future__ import annotations

import time

__all__ = ["RepoTuiModel", "run_tui"]


class RepoTuiModel:
    """View-model: live query -> results -> selected commit preview."""

    def __init__(self, indexer, top_k: int = 20, debounce_s: float = 0.15):
        self.indexer = indexer
        self.top_k = top_k
        self.debounce_s = debounce_s
        self.query = ""
        self.results: list[dict] = []
        self.selected = 0
        self.preview_scroll = 0
        self.status = "type to search"
        self._pending_since: float | None = None

    # -- input events ------------------------------------------------------------------
    def type_char(self, ch: str) -> None:
        self.query += ch
        self._pending_since = time.monotonic()
        self.status = "…"

    def backspace(self) -> None:
        if self.query:
            self.query = self.query[:-1]
            self._pending_since = time.monotonic()
            self.status = "…"

    def move(self, delta: int) -> None:
        if self.results:
            self.selected = max(0, min(len(self.results) - 1, self.selected + delta))
            self.preview_scroll = 0

    def scroll_preview(self, delta: int) -> None:
        self.preview_scroll = max(0, self.preview_scroll + delta)

    # -- search ------------------------------------------------------------------------
    def tick(self, now: float | None = None) -> bool:
        """Run the debounced search if due. Returns True when results changed."""
        if self._pending_since is None:
            return False
        now = time.monotonic() if now is None else now
        if now - self._pending_since < self.debounce_s:
            return False
        self._pending_since = None
        return self.refresh()

    def refresh(self) -> bool:
        q = self.query.strip()
        if not q:
            self.results = []
            self.selected = 0
            self.status = "type to search"
            return True
        t0 = time.perf_counter()
        try:
            self.results = self.indexer.search(q, self.top_k)
            self.status = f"{len(self.results)} hits in {1e3*(time.perf_counter()-t0):.0f} ms"
        except Exception as e:  # noqa: BLE001 — surface, don't crash the UI
            self.results = []
            self.status = f"search error: {type(e).__name__}: {e}"
        self.selected = 0
        self.preview_scroll = 0
        return True

    # -- preview -----------------------------------------------------------------------
    def preview_lines(self) -> list[str]:
        if not self.results or not (0 <= self.selected < len(self.results)):
            return []
        hit = self.results[self.selected]
        sha = hit.get("sha", "")
        # resolve the full commit document through the indexer's store
        try:
            text = self._commit_document(sha) or hit.get("preview", "")
        except Exception:  # noqa: BLE001
            text = hit.get("preview", "")
        header = [
            f"commit {sha}",
            f"author {hit.get('author', '')}",
            f"score  {hit.get('score', 0)}",
            "",
        ]
        return header + text.splitlines()

    def _commit_document(self, sha: str) -> str | None:
        store = self.indexer.orch.store
        from wax_tpu_torch.surfaces.repo import COMMIT_KIND

        for fid in store.frame_ids_of_kind(COMMIT_KIND):
            m = store.frame_meta(fid)
            if m is not None and m.metadata.get("sha") == sha:
                raw = store.frame_content(fid)
                return raw.decode("utf-8", errors="ignore") if raw else None
        return None


def _render(screen, model: RepoTuiModel) -> None:
    import curses

    screen.erase()
    h, w = screen.getmaxyx()

    def safe(y, x, s, *a):
        # guard BOTH axes and swallow curses errors (addnstr at the last cell of
        # some terminals raises even in-bounds) — a tiny window must degrade, not
        # crash the loop
        if not (0 <= y < h and 0 <= x < w - 1):
            return
        try:
            screen.addnstr(y, x, s, max(0, w - x - 1), *a)
        except curses.error:
            pass
    safe(0, 0, f"sift> {model.query}")
    safe(1, 0, "-" * max(0, w - 1))
    list_w = max(20, w // 2)
    n_rows = max(0, h - 4)
    for i, hit in enumerate(model.results[:n_rows]):
        marker = ">" if i == model.selected else " "
        line = f"{marker} {hit.get('sha', '')[:8]} {hit.get('author', '')[:14]:14} {hit.get('preview', '')}"
        attr = curses.A_REVERSE if i == model.selected else curses.A_NORMAL
        safe(2 + i, 0, line[: list_w - 1], attr)
    for j, line in enumerate(model.preview_lines()[model.preview_scroll :][:n_rows]):
        safe(2 + j, list_w + 1, line)
    for i in range(2, h - 2):
        safe(i, list_w, "|")
    safe(h - 1, 0, f"[{model.status}]  Up/Down select - PgUp/PgDn preview - Esc quit")
    screen.refresh()


def run_tui(indexer, screen=None) -> None:
    """Curses loop; pass a fake `screen` (getch/addnstr/erase/refresh/getmaxyx/
    timeout) to run headless (tests). With screen=None a real terminal is used."""
    import curses

    if screen is None:
        curses.wrapper(lambda scr: run_tui(indexer, scr))
        return
    model = RepoTuiModel(indexer)
    screen.timeout(50)  # getch returns -1 every 50 ms so debounce can fire
    while True:
        if model.tick():
            pass
        _render(screen, model)
        ch = screen.getch()
        if ch == -1:
            continue
        if ch in (27, 3):  # Esc / Ctrl-C
            break
        if ch in (curses.KEY_UP,):
            model.move(-1)
        elif ch in (curses.KEY_DOWN,):
            model.move(1)
        elif ch == curses.KEY_PPAGE:
            model.scroll_preview(-5)
        elif ch == curses.KEY_NPAGE:
            model.scroll_preview(5)
        elif ch in (curses.KEY_BACKSPACE, 127, 8):
            model.backspace()
        elif ch in (10, 13):  # Enter: run immediately, skip debounce
            model.refresh()
        elif 32 <= ch < 127:
            model.type_char(chr(ch))
