"""Google Cloud Storage input walking, the port's copy of `foldseek_tpu`'s
(reference: structcreatedb.cpp's GCS path, :1058-1288 — createdb accepts
gcs:// inputs and iterates bucket objects).

gs://bucket/prefix inputs are listed through the public GCS JSON API
(https://storage.googleapis.com/storage/v1/b/<bucket>/o?prefix=...) and
objects are downloaded into a local cache directory before parsing —
anonymous access, which is what the reference supports for the public
prediction databases. FOLDSEEK_TPU_GCS_ENDPOINT overrides the API root
(used by the tests to point at a local mock server; also works against
GCS emulators)."""
from __future__ import annotations

import json
import os
import urllib.parse
import urllib.request
from typing import List, Tuple

from ..utils.log import logger


def _endpoint() -> str:
    return os.environ.get("FOLDSEEK_TPU_GCS_ENDPOINT",
                          "https://storage.googleapis.com")


def is_gcs_path(path: str) -> bool:
    return path.startswith("gs://") or path.startswith("gcs://")


def split_gcs_path(path: str) -> Tuple[str, str]:
    rest = path.split("://", 1)[1]
    bucket, _, prefix = rest.partition("/")
    return bucket, prefix


def list_objects(bucket: str, prefix: str) -> List[str]:
    """Object names under the prefix (paginated)."""
    names: List[str] = []
    page_token = ""
    while True:
        q = {"prefix": prefix}
        if page_token:
            q["pageToken"] = page_token
        url = (f"{_endpoint()}/storage/v1/b/{urllib.parse.quote(bucket)}/o?"
               + urllib.parse.urlencode(q))
        with urllib.request.urlopen(url, timeout=60) as r:
            data = json.loads(r.read().decode())
        names += [item["name"] for item in data.get("items", [])]
        page_token = data.get("nextPageToken", "")
        if not page_token:
            break
    return names


def download_object(bucket: str, name: str, dest: str) -> str:
    url = (f"{_endpoint()}/storage/v1/b/{urllib.parse.quote(bucket)}/o/"
           f"{urllib.parse.quote(name, safe='')}?alt=media")
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    # download to a temp file, rename into place: an interrupted transfer
    # must not leave a truncated file that the cache check treats as done
    tmp = dest + ".part"
    with urllib.request.urlopen(url, timeout=300) as r, open(tmp, "wb") as f:
        while True:
            chunk = r.read(1 << 20)
            if not chunk:
                break
            f.write(chunk)
    os.replace(tmp, dest)
    return dest


def _safe_cache_dest(cache_dir: str, bucket: str, name: str) -> str:
    """Cache path for an object, rejecting names that would escape the
    cache dir (remote-controlled '..' or absolute components)."""
    dest = os.path.join(cache_dir, bucket, name.replace("/", os.sep))
    root = os.path.realpath(os.path.join(cache_dir, bucket))
    real = os.path.realpath(dest)
    if real != root and not real.startswith(root + os.sep):
        raise ValueError(f"gcs object name escapes cache dir: {name!r}")
    return dest


def fetch_gcs_inputs(path: str, cache_dir: str,
                     file_include: str = ".*",
                     file_exclude: str = "^$") -> List[str]:
    """Resolve a gs:// input to local file paths (downloaded to cache_dir).
    The include/exclude regexes filter on the object basename at
    listing time, BEFORE any download — an AFDB-scale prefix with a
    narrow --file-include must not transfer the excluded objects."""
    import re
    finc, fexc = re.compile(file_include), re.compile(file_exclude)
    bucket, prefix = split_gcs_path(path)
    names = [n for n in list_objects(bucket, prefix)
             if finc.search(os.path.basename(n))
             and not fexc.search(os.path.basename(n))]
    if not names:
        raise FileNotFoundError(f"{path}: no objects under prefix"
                                " (after include/exclude filtering)")
    logger.info("gcs: %d objects under gs://%s/%s", len(names), bucket, prefix)
    out = []
    for name in sorted(names):
        dest = _safe_cache_dest(cache_dir, bucket, name)
        if not os.path.isfile(dest):
            download_object(bucket, name, dest)
        out.append(dest)
    return out
