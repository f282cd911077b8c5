from .fasta import FastaReader
from .sequence import (
    contains_undefined,
    normalize_sequence,
    revcomp,
)
