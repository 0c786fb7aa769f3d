"""Pluggable object-store access for dataset blobs.

Analogue of the reference's ``TCSLoader`` petrel/s3 client
(``internvl/train/dataset.py:220-266``): datasets reference images/videos by
URL (``gs://``, ``s3://``, ``http(s)://``) or local path, and the loaders
below fetch bytes through a per-scheme opener registry. On GCP the natural
store is GCS; the google-cloud-storage / boto3 clients are imported lazily
and only if a URL of that scheme is actually seen, so local-disk training
never touches them.

Custom backends register with :func:`register_opener` (e.g. a cached
FUSE mount, or a test double) — the registry is the public hook the
round-1 ``datasets.load_image`` TODO pointed at.
"""

from __future__ import annotations

import io
import os
import tempfile
from typing import Callable, Dict, Optional

_OPENERS: Dict[str, Callable[[str], bytes]] = {}


def register_opener(scheme: str, fn: Callable[[str], bytes]) -> None:
    """Register ``fn(url) -> bytes`` for a URL scheme ('gs', 's3', ...)."""
    _OPENERS[scheme] = fn


def _scheme(path: str) -> Optional[str]:
    i = path.find("://")
    return path[:i].lower() if i > 0 else None


def _gs_fetch(url: str) -> bytes:
    try:
        from google.cloud import storage  # lazy; optional dependency
    except ImportError as e:
        raise RuntimeError(
            "gs:// paths need google-cloud-storage (not installed); "
            "register a custom opener via object_store.register_opener"
        ) from e
    bucket, _, blob = url[len("gs://"):].partition("/")
    return storage.Client().bucket(bucket).blob(blob).download_as_bytes()


def _s3_fetch(url: str) -> bytes:
    try:
        import boto3  # lazy; optional dependency
    except ImportError as e:
        raise RuntimeError(
            "s3:// paths need boto3 (not installed); register a custom "
            "opener via object_store.register_opener") from e
    bucket, _, key = url[len("s3://"):].partition("/")
    return boto3.client("s3").get_object(Bucket=bucket, Key=key)["Body"].read()


def _http_fetch(url: str) -> bytes:
    from urllib.request import urlopen

    with urlopen(url) as r:  # noqa: S310 — dataset URLs are operator-supplied
        return r.read()


def fetch_bytes(path: str) -> bytes:
    """Bytes of a blob at a URL or local path."""
    scheme = _scheme(path)
    if scheme is None or scheme == "file":
        with open(path.removeprefix("file://"), "rb") as f:
            return f.read()
    if scheme in _OPENERS:
        return _OPENERS[scheme](path)
    if scheme == "gs":
        return _gs_fetch(path)
    if scheme == "s3":
        return _s3_fetch(path)
    if scheme in ("http", "https"):
        return _http_fetch(path)
    raise ValueError(f"no opener registered for scheme {scheme!r} ({path})")


def open_blob(path: str) -> io.BytesIO:
    """File-like blob access (PIL.Image.open-compatible)."""
    return io.BytesIO(fetch_bytes(path))


def is_remote(path: str) -> bool:
    s = _scheme(path)
    return s is not None and s != "file"


def localize(path: str) -> str:
    """Local filesystem path for a blob — remote blobs are downloaded to a
    temp file (cv2/imageio need a real path for video decode)."""
    if not is_remote(path):
        return path
    suffix = os.path.splitext(path)[1]
    f = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    f.write(fetch_bytes(path))
    f.close()
    return f.name
