"""Pluggable byte-reading backends for dataset IO.

The port's own copy of ``tair_tpu/data/file_backend.py``: the disk backend the
SA-Text path uses, an in-memory store for tests, and the S3/Petrel seam as a
stub that fails loudly at construction (its client is not installed).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Union


class BaseBackend:
    def get(self, filepath: Union[str, Path]) -> bytes:
        raise NotImplementedError


class HardDiskBackend(BaseBackend):
    """Raw bytes from the local filesystem."""

    def get(self, filepath: Union[str, Path]) -> bytes:
        with open(filepath, "rb") as f:
            return f.read()


class MemoryBackend(BaseBackend):
    """In-memory {path: bytes} store for tests and synthetic data."""

    def __init__(self, store: Dict[str, bytes] | None = None):
        self.store = dict(store or {})

    def put(self, filepath: Union[str, Path], data: bytes) -> None:
        self.store[str(filepath)] = data

    def get(self, filepath: Union[str, Path]) -> bytes:
        return self.store[str(filepath)]


class PetrelBackend(BaseBackend):
    """S3-style object storage via the petrel client (not installed; kept as
    the configuration seam)."""

    def __init__(self, *args, **kwargs):
        raise RuntimeError(
            "PetrelBackend requires the petrel_client package and cluster "
            "credentials; use HardDiskBackend (the default)"
        )


_BACKENDS = {
    "disk": HardDiskBackend,
    "memory": MemoryBackend,
    "petrel": PetrelBackend,
}


def get_backend(name: str, **kwargs) -> BaseBackend:
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown file backend {name!r}; choose from {sorted(_BACKENDS)}"
        ) from None
    return cls(**kwargs)
