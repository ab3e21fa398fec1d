"""Transparent input open — the kopen equivalent.

Dispatch contract (bwalib/kopen.c:268-336):
  * ``http://...``  -> HTTP GET of the body          (http_open :78)
  * ``ftp://...``   -> anonymous FTP RETR            (ftp_open :181)
  * ``-``           -> stdin
  * ``<cmd args``   -> run the command, read stdout  (pipe open :287-320);
                       a shell is interposed iff the command text contains
                       punctuation other than ``. _ - :`` (:292-295)
  * anything else   -> plain file

Downstream of kopen the reference reads through zlib's gzFile, which
auto-detects gzip streams; ``kopen_text`` mirrors that by sniffing the
two-byte gzip magic on whatever byte stream the dispatch produced.
"""

from __future__ import annotations

import gzip
import io
import shlex
import subprocess
import sys


class _PrependStream(io.RawIOBase):
    """A readable raw stream that replays ``head`` before ``base``."""

    def __init__(self, head: bytes, base):
        self._head = head
        self._base = base

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        if self._head:
            n = min(len(b), len(self._head))
            b[:n] = self._head[:n]
            self._head = self._head[n:]
            return n
        data = self._base.read(len(b))
        if not data:
            return 0
        b[: len(data)] = data
        return len(data)

    def close(self) -> None:
        try:
            base = self._base
            if base is not sys.stdin.buffer:
                base.close()
        finally:
            super().close()


class _ProcStream(io.RawIOBase):
    """Pipe stdout reader that retains the Popen: on close, reap the child
    and surface a non-zero exit code (the reference's pclose-equivalent at
    kopen.c:355-370 waits on the worker process)."""

    def __init__(self, proc: subprocess.Popen, cmd: str):
        self._proc = proc
        self._cmd = cmd

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self._proc.stdout.read(len(b))
        if not data:
            return 0
        b[: len(data)] = data
        return len(data)

    def close(self) -> None:
        if self.closed:
            return
        try:
            self._proc.stdout.close()
            rc = self._proc.wait()
            if rc != 0:
                print(f"[W::kopen] command {self._cmd!r} exited with "
                      f"status {rc}", file=sys.stderr)
        finally:
            super().close()


def _needs_shell(cmd: str) -> bool:
    """kopen.c:292-295 — any punctuation beyond ``. _ - :`` implies shell
    metacharacters (pipes, redirects, quotes) and routes through /bin/sh."""
    for ch in cmd:
        if not ch.isalnum() and not ch.isspace() and ch not in "._-:":
            return True
    return False


def kopen(path: str):
    """Open ``path`` per the dispatch table above; returns a binary stream."""
    if path.startswith("http://") or path.startswith("ftp://"):
        from urllib.request import urlopen

        return urlopen(path)
    if path == "-":
        return sys.stdin.buffer
    stripped = path.lstrip()
    if stripped.startswith("<"):
        cmd = stripped[1:].strip()
        if _needs_shell(cmd):
            proc = subprocess.Popen(cmd, shell=True, stdout=subprocess.PIPE)
        else:
            proc = subprocess.Popen(shlex.split(cmd), stdout=subprocess.PIPE)
        return io.BufferedReader(_ProcStream(proc, cmd))
    return open(path, "rb")


def kopen_text(path: str):
    """kopen + gzip auto-detection, decoded to a text stream."""
    raw = kopen(path)
    head = raw.read(2)
    stream = io.BufferedReader(_PrependStream(head, raw))
    if head == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=stream))
    return io.TextIOWrapper(stream)
