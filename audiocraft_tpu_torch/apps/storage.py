"""Artifact storage + short-URL permalinks (a copy of
``audiocraft_tpu/apps/storage.py``, the standard library only, which the
port may not import).

Capability counterpart of the fork's ``modules/storage.py`` (HF dataset-repo
uploads, shortener.json short-URL registry, permalink construction).  This
store is backend-pluggable, so that a host without network access keeps the
same semantics:

* :class:`LocalStore` — a local directory standing in for the dataset repo
  (same folder layout, same shortener.json registry semantics).
* :class:`HFStore` — the hub-backed implementation, constructed lazily from
  ``huggingface_hub`` when that package and a token are available (the
  reference's ``upload_files_to_repo`` / ``_upload_json_to_repo`` role).

The URL-shortener logic (random short ids, collision re-use, JSON registry)
is shared and identical across backends.
"""

from __future__ import annotations

import json
import secrets
import shutil
import string
import time
import typing as tp
import urllib.parse
from pathlib import Path

AUDIO_EXTS = {'.wav', '.mp3', '.flac', '.ogg', '.m4a'}
VIDEO_EXTS = {'.mp4', '.webm'}
IMAGE_EXTS = {'.png', '.jpg', '.jpeg', '.gif'}
SHORTENER_FILE = 'shortener.json'


def _short_id(length: int = 8) -> str:
    alphabet = string.ascii_letters + string.digits
    return ''.join(secrets.choice(alphabet) for _ in range(length))


class LocalStore:
    """Filesystem-backed artifact store with repo-like folder semantics."""

    def __init__(self, root: tp.Union[str, Path],
                 base_url: str = 'file://'):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.base_url = base_url.rstrip('/')

    def upload_files(self, files: tp.Sequence[tp.Union[str, Path]],
                     folder_name: str) -> tp.List[tp.Tuple[str, str]]:
        """Copy files under <root>/<folder_name>/; returns
        [(path_in_repo, url)] like the reference's upload_files_to_repo."""
        dest = self.root / folder_name
        dest.mkdir(parents=True, exist_ok=True)
        out = []
        for f in files:
            f = Path(f)
            target = dest / f.name
            shutil.copy(f, target)
            rel = f"{folder_name}/{f.name}"
            out.append((rel, f"{self.base_url}/{target.resolve()}"))
        return out

    def read_json(self, name: str) -> tp.Any:
        path = self.root / name
        if not path.exists():
            return []
        return json.loads(path.read_text())

    def write_json(self, name: str, data: tp.Any) -> None:
        (self.root / name).write_text(json.dumps(data, indent=2))


class HFStore:  # pragma: no cover - network-bound; exercised when hub exists
    """huggingface_hub-backed store (the reference's dataset-repo uploads)."""

    def __init__(self, repo_id: str, token: tp.Optional[str] = None,
                 repo_type: str = 'dataset'):
        from huggingface_hub import HfApi
        self.api = HfApi(token=token)
        self.repo_id = repo_id
        self.repo_type = repo_type
        self.base_url = (f"https://huggingface.co/datasets/{repo_id}/resolve/"
                         f"main")

    def upload_files(self, files, folder_name):
        out = []
        for f in files:
            f = Path(f)
            rel = f"{folder_name}/{f.name}"
            self.api.upload_file(path_or_fileobj=str(f), path_in_repo=rel,
                                 repo_id=self.repo_id,
                                 repo_type=self.repo_type)
            out.append((rel, f"{self.base_url}/{urllib.parse.quote(rel)}"))
        return out

    def read_json(self, name):
        from huggingface_hub import hf_hub_download
        try:
            path = hf_hub_download(repo_id=self.repo_id, filename=name,
                                   repo_type=self.repo_type)
        except Exception:
            return []
        return json.loads(Path(path).read_text())

    def write_json(self, name, data):
        import io
        payload = json.dumps(data, indent=2).encode()
        self.api.upload_file(path_or_fileobj=io.BytesIO(payload),
                             path_in_repo=name, repo_id=self.repo_id,
                             repo_type=self.repo_type)


# -------------------------------------------------------------- shortener

def shorten_url(store, full_url: str,
                json_file: str = SHORTENER_FILE) -> str:
    """Register `full_url` in the store's shortener registry and return its
    short id (reusing an existing mapping — reference gen_full_url
    'create' path)."""
    data = store.read_json(json_file)
    for entry in data:
        if entry.get('full_url') == full_url:
            return entry['short_url']
    short = _short_id()
    taken = {e.get('short_url') for e in data}
    while short in taken:
        short = _short_id()
    data.append({'short_url': short, 'full_url': full_url,
                 'created': time.strftime('%Y%m%d-%H%M%S')})
    store.write_json(json_file, data)
    return short


def resolve_url(store, short_url: str,
                json_file: str = SHORTENER_FILE) -> tp.Optional[str]:
    """Short id -> full URL (reference gen_full_url 'retrieve' path)."""
    for entry in store.read_json(json_file):
        if entry.get('short_url') == short_url:
            return entry['full_url']
    return None


def generate_permalink(uploaded: tp.Sequence[tp.Tuple[str, str]],
                       viewer_url: str = 'player.local') -> tp.Optional[str]:
    """Build a viewer permalink from uploaded (path, url) pairs: one audio
    (+ optional video/image) — the audio-app analogue of the reference's
    model+images permalink (storage.py:16-63)."""
    audio = [u for p, u in uploaded if Path(p).suffix.lower() in AUDIO_EXTS]
    video = [u for p, u in uploaded if Path(p).suffix.lower() in VIDEO_EXTS]
    image = [u for p, u in uploaded if Path(p).suffix.lower() in IMAGE_EXTS]
    if not audio:
        return None
    params = {'audio': audio[0]}
    if video:
        params['video'] = video[0]
    if image:
        params['image'] = image[0]
    return f"https://{viewer_url}/?{urllib.parse.urlencode(params)}"


def publish(store, files: tp.Sequence[tp.Union[str, Path]],
            folder_name: str,
            make_permalink: bool = True) -> tp.Dict[str, tp.Any]:
    """One-call pipeline: upload artifacts, register a short URL for the
    permalink.  Returns {'files': [(rel, url)], 'permalink', 'short_url'}."""
    uploaded = store.upload_files(files, folder_name)
    result: tp.Dict[str, tp.Any] = {'files': uploaded}
    if make_permalink:
        link = generate_permalink(uploaded)
        if link is not None:
            result['permalink'] = link
            result['short_url'] = shorten_url(store, link)
    return result
