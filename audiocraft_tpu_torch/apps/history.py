"""Local generation history (a copy of ``audiocraft_tpu/apps/history.py``,
the standard library and ``filelock`` only, which the port may not
import) — the storage core of the fork's
``modules/user_history.py`` (per-user gallery: filelock-guarded jsonl of
generations plus copies of the audio/image files, :333-741), without the
Gradio gallery / HF-hub upload layers (UI- and network-bound; seams only).
"""

from __future__ import annotations

import json
import shutil
import time
import typing as tp
from pathlib import Path

# imported with the module (the JAX package imports it in ``save``), so an
# importer's later stand-in for the name cannot take the lock's place
from filelock import FileLock


class GenerationHistory:
    """Append-only per-user history: jsonl metadata + copied artifacts."""

    def __init__(self, folder: tp.Union[str, Path], user: str = "local"):
        self.root = Path(folder) / user
        self.root.mkdir(parents=True, exist_ok=True)
        self.jsonl = self.root / "history.jsonl"

    def save(self, audio_path: tp.Union[str, Path],
             label: str = "",
             metadata: tp.Optional[dict] = None,
             image_path: tp.Optional[tp.Union[str, Path]] = None) -> dict:
        ts = time.strftime("%Y%m%d-%H%M%S")
        audio_path = Path(audio_path)
        dest_audio = self.root / f"{ts}{audio_path.suffix}"
        i = 0
        while dest_audio.exists():
            i += 1
            dest_audio = self.root / f"{ts}-{i}{audio_path.suffix}"
        shutil.copy(audio_path, dest_audio)
        entry = {
            "timestamp": ts,
            "label": label,
            "audio": dest_audio.name,
            "metadata": metadata or {},
        }
        if image_path is not None:
            dest_img = dest_audio.with_suffix(Path(image_path).suffix)
            shutil.copy(image_path, dest_img)
            entry["image"] = dest_img.name
        # append under a real blocking file lock (reference
        # user_history.py:351 uses filelock the same way — no silent
        # lock-skip on contention)
        with FileLock(str(self.jsonl.with_suffix(".lock"))):
            with open(self.jsonl, "a") as fp:
                fp.write(json.dumps(entry) + "\n")
        return entry

    def list(self) -> tp.List[dict]:
        if not self.jsonl.exists():
            return []
        return [json.loads(line) for line in self.jsonl.read_text().splitlines()
                if line.strip()]

    def delete(self, audio_name: str) -> None:
        entries = [e for e in self.list() if e["audio"] != audio_name]
        for suffix_file in self.root.glob(Path(audio_name).stem + ".*"):
            suffix_file.unlink(missing_ok=True)
        self.jsonl.write_text("".join(json.dumps(e) + "\n" for e in entries))

    def export_zip(self, dest: tp.Union[str, Path]) -> Path:
        archive = shutil.make_archive(str(dest), "zip", self.root)
        return Path(archive)

    def delete_all(self, archive_dir: tp.Optional[tp.Union[str, Path]] = None
                   ) -> tp.Optional[Path]:
        """Wipe this user's history (reference _delete_user_history,
        user_history.py:453-480: archive to a zip first, then clear).
        Returns the archive path when archiving was requested."""
        archive = None
        if archive_dir is not None:
            stamp = time.strftime("%Y%m%d-%H%M%S")
            dest = Path(archive_dir) / f"history-{self.root.name}-{stamp}"
            dest.parent.mkdir(parents=True, exist_ok=True)
            archive = self.export_zip(dest)
        for child in self.root.iterdir():
            if child.suffix == ".lock":
                continue
            if child.is_dir():
                shutil.rmtree(child)
            else:
                child.unlink()
        return archive


def admin_stats(folder: tp.Union[str, Path]) -> dict:
    """Cross-user stats over a history root — the data behind the reference
    admin panel (user_history.py:637-740: user count, artifact counts, disk
    usage/free)."""
    root = Path(folder)
    users = [p for p in root.iterdir() if p.is_dir()] if root.is_dir() else []
    n_audio = n_image = n_video = n_entries = 0
    for user in users:
        jsonl = user / "history.jsonl"
        if jsonl.exists():
            n_entries += sum(1 for ln in jsonl.read_text().splitlines()
                             if ln.strip())
        for f in user.iterdir():
            suffix = f.suffix.lower()
            if suffix in (".wav", ".mp3", ".ogg", ".flac", ".m4a", ".opus"):
                n_audio += 1
            elif suffix in (".png", ".jpg", ".jpeg", ".webp"):
                n_image += 1
            elif suffix in (".mp4", ".webm"):
                n_video += 1
    usage = shutil.disk_usage(root if root.is_dir() else root.parent)
    return {
        "users": len(users),
        "entries": n_entries,
        "audio_files": n_audio,
        "images": n_image,
        "videos": n_video,
        "disk_used_gb": round(usage.used / 2 ** 30, 2),
        "disk_free_gb": round(usage.free / 2 ** 30, 2),
        "disk_total_gb": round(usage.total / 2 ** 30, 2),
    }


def render_admin_html(folder: tp.Union[str, Path]) -> str:
    """Admin panel content (reference _admin_content,
    user_history.py:653-676) as static HTML."""
    stats = admin_stats(folder)
    rows = "".join(f"<tr><td>{k.replace('_', ' ')}</td><td>{v}</td></tr>"
                   for k, v in stats.items())
    warn = ""
    if stats["disk_free_gb"] < 5:
        warn = ("<p class='warn'>Low disk space: "
                f"{stats['disk_free_gb']} GB free</p>")
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        "<title>History admin</title><style>"
        "body{font-family:sans-serif;background:#0b0f19;color:#eee;margin:2em}"
        "table{border-collapse:collapse}td{padding:0.3em 1em;"
        "border-bottom:1px solid #334}.warn{color:#f66}"
        "</style></head><body><h1>History admin</h1>"
        f"{warn}<table>{rows}</table></body></html>")


def render_gallery_html(history: "GenerationHistory",
                        title: str = "Generation history",
                        page: int = 0, per_page: int = 50) -> str:
    """Static HTML gallery over a GenerationHistory — the gradio-free
    counterpart of the reference's per-user gallery tab
    (user_history.py:333-741): newest first, audio players, metadata lines,
    simple pagination."""
    entries = list(reversed(history.list()))
    pages = max(1, (len(entries) + per_page - 1) // per_page)
    page = max(0, min(page, pages - 1))
    chunk = entries[page * per_page:(page + 1) * per_page]
    cards = []
    for e in chunk:
        meta = " | ".join(f"{k}: {v}" for k, v in e.get("metadata", {}).items()
                          if isinstance(v, (str, int, float)))
        img = (f'<img src="{e["image"]}" alt="" width="240"/>'
               if e.get("image") else "")
        cards.append(
            f'<div class="card"><h3>{e.get("label", "")}</h3>'
            f'<p class="ts">{e.get("timestamp", "")}</p>{img}'
            f'<audio controls src="{e["audio"]}"></audio>'
            f'<p class="meta">{meta}</p></div>')
    nav = " ".join(
        f'<a href="?page={i}"{" class=cur" if i == page else ""}>{i + 1}</a>'
        for i in range(pages))
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title><style>"
        "body{font-family:sans-serif;background:#0b0f19;color:#eee;margin:2em}"
        ".card{background:#151b2c;padding:1em;margin:1em 0;border-radius:8px}"
        ".ts{color:#8aa;font-size:0.8em}.meta{color:#aab;font-size:0.85em}"
        "a{color:#6cf;margin-right:0.5em}a.cur{font-weight:bold}"
        "</style></head><body>"
        f"<h1>{title}</h1><p>{len(entries)} generations</p>"
        f"{''.join(cards)}<p class='nav'>{nav}</p></body></html>")


def write_gallery(history: "GenerationHistory",
                  dest: tp.Optional[tp.Union[str, Path]] = None) -> Path:
    """Write the gallery page next to the stored artifacts (relative audio
    paths resolve) and return its path."""
    dest = Path(dest) if dest else history.root / "index.html"
    dest.write_text(render_gallery_html(history))
    return dest
