"""``zip_path:file_path`` paths into zip archives, with the archives' handles
cached (counterpart of ``audiocraft_tpu/data/zip.py``; the reference's
``data/zip.py``:22-77)."""

from __future__ import annotations

import dataclasses
import io
import zipfile
from functools import lru_cache


@dataclasses.dataclass(order=True)
class PathInZip:
    """``zip_path:file_path``, a member of a zip archive."""
    INFO_PATH_SEP = ':'
    zip_path: str
    file_path: str

    def __init__(self, path: str) -> None:
        split_path = path.split(self.INFO_PATH_SEP)
        if len(split_path) != 2:
            raise ValueError(f"invalid zip path {path!r}")
        self.zip_path, self.file_path = split_path

    def __str__(self) -> str:
        return self.zip_path + self.INFO_PATH_SEP + self.file_path

    def __hash__(self):
        return hash(str(self))


@lru_cache(32)
def _open_zip(path: str, mode: str = 'r') -> zipfile.ZipFile:
    return zipfile.ZipFile(path, mode)


def set_zip_cache_size(max_size: int) -> None:
    global _open_zip
    _open_zip = lru_cache(max_size)(_open_zip.__wrapped__)  # type: ignore


def open_file_in_zip(path_in_zip: PathInZip, mode: str = 'r') -> io.IOBase:
    zf = _open_zip(path_in_zip.zip_path)
    return zf.open(path_in_zip.file_path)  # type: ignore
