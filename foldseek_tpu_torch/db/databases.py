"""Prebuilt-database download pipeline — the `databases` verb's engine, the
port's copy of `foldseek_tpu`'s, whose post-processing calls the port's
`create_db` (reference: data/structdatabases.sh + src/FoldseekBase.cpp:446-551
externalDownloads: download, checksum, unpack, post-process into a ready
search DB).

Steps per database:
1. download to <tmp>/<file>.part, rename when complete (resumes skip
   finished files); FOLDSEEK_TPU_DB_MIRROR overrides the URL host so
   mirrors / the test's local mock server serve the payloads;
2. md5 verification when the server publishes <file>.md5 alongside;
3. unpack (tar, tar.gz, tar.zst, plain .gz) into the tmp dir;
4. post-process by content:
   - structure files (PDB/mmCIF/foldcomp)  -> createdb into <output>
   - a FASTA file                          -> createdb (ProstT5 3Di when
     a model is supplied)
   - a GGUF file (the ProstT5 weights DB)  -> placed at <output>
   - an already array-native DB directory  -> moved to <output>
"""
from __future__ import annotations

import hashlib
import os
import shutil
import tarfile
import urllib.error
import urllib.parse
import urllib.request

from ..utils.log import logger


def _mirror_url(url: str) -> str:
    mirror = os.environ.get("FOLDSEEK_TPU_DB_MIRROR", "")
    if not mirror:
        return url
    path = urllib.parse.urlparse(url).path
    return mirror.rstrip("/") + path


def _download(url: str, dest: str) -> str:
    if os.path.isfile(dest):
        logger.info("databases: reusing %s", dest)
        return dest
    tmp = dest + ".part"
    logger.info("databases: downloading %s", url)
    with urllib.request.urlopen(url, timeout=300) as r, open(tmp, "wb") as f:
        shutil.copyfileobj(r, f, 1 << 20)
    os.replace(tmp, dest)
    return dest


def _verify_md5(url: str, archive: str) -> None:
    """Fetch <url>.md5 when the server provides it and compare; a missing
    checksum file is not an error (the reference's check is also
    best-effort per database)."""
    try:
        with urllib.request.urlopen(url + ".md5", timeout=60) as r:
            want = r.read().decode().split()[0].strip()
    except (urllib.error.URLError, OSError, IndexError):
        logger.info("databases: no md5 published for %s", url)
        return
    h = hashlib.md5()
    with open(archive, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    if h.hexdigest() != want:
        raise ValueError(
            f"md5 mismatch for {archive}: got {h.hexdigest()}, want {want}")
    logger.info("databases: md5 verified (%s)", want)


def _unpack(archive: str, into: str) -> str:
    """Unpack the archive; returns the content directory."""
    out = os.path.join(into, "content")
    os.makedirs(out, exist_ok=True)
    if tarfile.is_tarfile(archive):
        with tarfile.open(archive) as tar:
            tar.extractall(out, filter="data")
        return out
    if archive.endswith(".zst"):
        from ..utils.zstd import decompress
        dst = os.path.join(out, os.path.basename(archive)[:-4])
        with open(archive, "rb") as src, open(dst, "wb") as f:
            f.write(decompress(src.read()))
        if tarfile.is_tarfile(dst):
            with tarfile.open(dst) as tar:
                tar.extractall(out, filter="data")
            os.unlink(dst)
        return out
    if archive.endswith(".gz"):
        import gzip
        dst = os.path.join(out, os.path.basename(archive)[:-3])
        with gzip.open(archive, "rb") as src, open(dst, "wb") as f:
            shutil.copyfileobj(src, f)
        return out
    # plain payload (e.g. a GGUF)
    shutil.copy(archive, out)
    return out


def _post_process(content_dir: str, output: str,
                  prostt5_model: str = "") -> str:
    """Turn the unpacked payload into the ready artifact at `output`."""
    entries = []
    for root, _, files in os.walk(content_dir):
        entries += [os.path.join(root, f) for f in files]
    if not entries:
        raise ValueError(f"{content_dir}: empty download")

    # a ready array-native DB?
    for root, dirs, files in os.walk(content_dir):
        if "manifest.json" in files:
            if os.path.isdir(output):
                shutil.rmtree(output)
            shutil.move(root, output)
            return output

    ggufs = [e for e in entries if e.endswith(".gguf")]
    if ggufs:
        shutil.move(ggufs[0], output)
        logger.info("databases: model weights -> %s", output)
        return output

    fastas = [e for e in entries
              if e.endswith((".fasta", ".fa", ".fasta.gz", ".fa.gz"))]
    # metadata files that ride along in release archives are not payload
    # NOTE: .json stays payload — mmJSON is a supported structure format
    META_SUFFIXES = (".md5", ".version", ".txt", ".md", ".tsv",
                     ".log", ".html", ".yml", ".yaml")
    META_NAMES = {"readme", "license", "licence", "copying", "changelog",
                  "notice", "authors", "citation"}
    structs = [e for e in entries
               if not e.lower().endswith(META_SUFFIXES)
               and os.path.basename(e).lower().split(".")[0] not in META_NAMES
               and e not in fastas]
    from ..ingest.createdb import create_db
    if structs:
        create_db(structs, output)
    elif fastas:
        create_db(fastas, output, prostt5_model=prostt5_model)
    else:
        raise ValueError(f"{content_dir}: no usable payload found")
    return output


def download_database(name: str, url: str, output: str, tmp_dir: str,
                      prostt5_model: str = "") -> str:
    os.makedirs(tmp_dir, exist_ok=True)
    url = _mirror_url(url)
    fname = os.path.basename(urllib.parse.urlparse(url).path) or "payload"
    archive = _download(url, os.path.join(tmp_dir, fname))
    _verify_md5(url, archive)
    content = _unpack(archive, tmp_dir)
    return _post_process(content, output, prostt5_model=prostt5_model)
