from .mer import (
    canonicalize,
    encode_kmer,
    decode_kmer,
    enumerate_valid_kmers,
    rolling_kmers_with_final,
    revcomp_kmer,
)
from .counter import ExactKmerCounter, KmerCounter
from .histogram import Histogram, compute_kmer_coverage_from_peaks
from .device_counter import DeviceKmerCounter, sharded_count_kmers
from .jf_reader import read_jf
from .unique import (
    StepwiseUniqueKmerComputer,
    UniqueKmerComputer,
    UniqueKmersRecord,
)
