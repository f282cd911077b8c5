"""FASTA parsing.

Host-side equivalent of the reference FastaReader
(src/fastareader.cpp:7-105): loads the whole file into a
name -> sequence map, supports subsequence extraction, size queries and
moving one chromosome's sequence into a fresh reader (used so each
per-chromosome graph owns exactly its own sequence).
"""

from __future__ import annotations

import gzip
from typing import Dict, Iterator, List, Tuple

from .sequence import normalize_sequence


def _open_text(filename: str):
    if filename.endswith(".gz"):
        return gzip.open(filename, "rt")
    return open(filename, "r")


class FastaReader:
    """In-memory FASTA with reference-compatible name handling.

    Sequence names are the first whitespace-delimited token after '>'
    (reference src/fastareader.cpp:27-38). Later records with the same
    name replace earlier ones. Sequences are stored uppercased.
    """

    def __init__(self, filename: str | None = None):
        self._sequences: Dict[str, bytes] = {}
        if filename is not None:
            self._parse(filename)

    def _parse(self, filename: str) -> None:
        name = None
        chunks: List[bytes] = []
        try:
            fh = _open_text(filename)
        except OSError as e:
            raise RuntimeError(
                f"FastaReader: reference file {filename} cannot be opened."
            ) from e
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                if line[0] == ">":
                    if name is not None:
                        self._sequences[name] = b"".join(chunks)
                    name = line[1:].split()[0]
                    chunks = []
                else:
                    if name is None:
                        raise RuntimeError("FastaReader: file is malformatted.")
                    chunks.append(normalize_sequence(line))
        if name is not None:
            self._sequences[name] = b"".join(chunks)

    # -- queries ---------------------------------------------------------

    def contains_name(self, name: str) -> bool:
        return name in self._sequences

    def get_size_of(self, name: str) -> int:
        try:
            return len(self._sequences[name])
        except KeyError:
            raise RuntimeError(
                f"FastaReader: chromosome {name} is not present in FASTA-file."
            )

    def get_subsequence(self, name: str, start: int, end: int) -> bytes:
        """Sequence [start, end) of chromosome `name` (0-based)."""
        try:
            seq = self._sequences[name]
        except KeyError:
            raise RuntimeError(
                f"FastaReader: chromosome {name} is not present in FASTA-file."
            )
        if start > end or end > len(seq) or start < 0:
            raise RuntimeError("FastaReader: invalid subsequence coordinates.")
        return seq[start:end]

    def get_sequence(self, name: str) -> bytes:
        return self._sequences[name]

    def get_names(self) -> List[str]:
        return list(self._sequences.keys())

    def get_total_kmers(self, kmer_size: int) -> int:
        """Total k-mer windows over all sequences
        (reference src/fastareader.cpp: size - k + 1 per sequence)."""
        return sum(
            max(0, len(s) - kmer_size + 1) for s in self._sequences.values()
        )

    def extract_name(self, name: str) -> "FastaReader":
        """Move one chromosome's sequence into a new FastaReader.

        Mirrors FastaReader::extract_name (src/fastareader.cpp:94-105):
        the sequence is removed from this reader and owned by the result.
        """
        if name not in self._sequences:
            raise RuntimeError(
                f"FastaReader: chromosome {name} is not present in FASTA-file."
            )
        result = FastaReader()
        result._sequences[name] = self._sequences.pop(name)
        return result

    def items(self) -> Iterator[Tuple[str, bytes]]:
        return iter(self._sequences.items())
