"""Pangenome construction from a phased multi-sample VCF + reference FASTA.

Replaces the reference ``GraphBuilder`` (src/graphbuilder.cpp:55-353):
streams the VCF once, validates records, clusters variants closer than
k-1 bp, merges each cluster into a bubble, and derives the k-mer
counting corpus (reference unitigs between bubbles plus every allele
sequence with flanks).

TPU-first note: this stays host-side by design — parsing and graph
topology are irregular, pointer-ish work; the output of this layer is
what gets densified into device tensors downstream.
"""

from __future__ import annotations

import re
from typing import Dict, List

from ..io.fasta import FastaReader
from ..io.sequence import normalize_sequence
from .graph import ChromosomeGraph
from .variant import VariantBubble

_ALT_PATTERN = re.compile(rb"^[CAGTcagt,]+$")

_VCF_FIELDS = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO", "FORMAT"]


_ATOI_RE = re.compile(r"\s*[+-]?\d+")


def _atoi(s: str) -> int:
    """C atoi: leading integer prefix, 0 if none."""
    try:
        return int(s)  # fast path: plain genotype indices
    except ValueError:
        m = _ATOI_RE.match(s)
        return int(m.group()) if m else 0


def _parse_info_ids(info: str) -> List[str]:
    """Extract the comma-separated INFO ID= values.

    (reference src/graphbuilder.cpp:44-53)
    """
    for field in info.split(";"):
        if field.startswith("ID="):
            return field[3:].split(",")
    return []


class PanelBuilder:
    """Builds per-chromosome ChromosomeGraph objects from VCF + FASTA."""

    def __init__(
        self,
        vcf_filename: str,
        reference_filename: str,
        segments_filename: str | None,
        kmer_size: int,
        add_reference: bool,
    ):
        self.kmer_size = kmer_size
        self.nr_variants = 0
        self.nr_paths = 0
        self.chromosomes: List[str] = []
        self.graphs: Dict[str, ChromosomeGraph] = {}

        fasta_reader = FastaReader(reference_filename)
        self._construct_graph(vcf_filename, fasta_reader, add_reference)
        if segments_filename is not None:
            self.write_path_segments(segments_filename, fasta_reader)
        self._leftover_fasta = fasta_reader

    # -- VCF streaming ---------------------------------------------------

    def _construct_graph(
        self, filename: str, fasta_reader: FastaReader, add_reference: bool
    ) -> None:
        """Stream the VCF into per-chromosome graphs.

        Fast path: the native scanner (csrc pg_parse_vcf_chunk)
        tokenizes + validates whole byte chunks and this side only
        assembles VariantBubbles from offset arrays. ANY anomaly makes
        the native side bail, and the file is re-parsed from scratch by
        the reference-faithful Python loop so every error message and
        edge case matches the reference exactly
        (src/graphbuilder.cpp:55-279).
        """
        if filename.endswith(".gz"):
            raise RuntimeError("PanelBuilder: uncompressed VCF-file is required.")
        import os as _os

        from ..kmers import native as _native

        if _native.available() and not _os.environ.get(
            "PANGENIE_TPU_NO_NATIVE_VCF"
        ):
            names0 = fasta_reader.get_names()
            try:
                fh = open(filename, "rb")
            except OSError as e:
                raise RuntimeError(
                    "PanelBuilder: input VCF file cannot be opened."
                ) from e
            with fh:
                done = self._construct_graph_native(
                    fh, fasta_reader, add_reference
                )
            if done:
                return
            # bail: undo any chromosome extraction (in original FASTA
            # order) and reset state before the exact-semantics re-parse
            seqs = fasta_reader._sequences
            for name, graph in self.graphs.items():
                seqs[name] = graph.fasta_reader._sequences[name]
            fasta_reader._sequences = {
                n: seqs[n] for n in names0 if n in seqs
            }
            self.graphs = {}
            self.chromosomes = []
            self.nr_variants = 0
            self.nr_paths = 0
        self._construct_graph_python(filename, fasta_reader, add_reference)

    def _finalize_graphs(self) -> None:
        # order chromosomes by descending number of bubbles (reference
        # processes big chromosomes first for better thread packing)
        sizes = sorted(
            ((g.size(), name) for name, g in self.graphs.items()), reverse=True
        )
        self.chromosomes = [name for _, name in sizes]
        self.nr_variants = sum(g.size() for g in self.graphs.values())

    def _validate_header_line(self, line: str, add_reference: bool) -> int:
        """Validate one '#...' header line, returning the sample count
        (and setting nr_paths) exactly as the streaming loop does."""
        tokens = line.split("\t")
        if len(tokens) < 9:
            raise RuntimeError("PanelBuilder: not a proper VCF-file.")
        if len(tokens) < 10:
            raise RuntimeError("PanelBuilder: no haplotype paths given.")
        for i in range(9):
            if tokens[i] != _VCF_FIELDS[i]:
                raise RuntimeError("PanelBuilder: VCF header line is malformed.")
        nr_samples = len(tokens) - 9
        self.nr_paths = nr_samples * 2
        if add_reference:
            self.nr_paths += 1
        return nr_samples

    def _construct_graph_native(
        self, fh, fasta_reader: FastaReader, add_reference: bool
    ) -> bool:
        """Chunked native parse. Returns False to request the Python
        re-parse (any anomaly), True when the build completed."""
        from ..kmers import native as _native

        k = self.kmer_size
        chrom_names = fasta_reader.get_names()
        chrom_index = {n: i for i, n in enumerate(chrom_names)}
        chrom_names_b = [n.encode("ascii") for n in chrom_names]
        # snapshot sequence refs: extract_name pops them from the
        # reader as graphs take ownership, but the bytes stay alive
        chrom_seqs = [fasta_reader.get_sequence(n) for n in chrom_names]

        header_seen = False
        nr_samples = 0
        prev_chrom = -1
        prev_end = 0
        cur_ci = -1
        cur_name = ""
        cur_seq = b""
        current_graph: ChromosomeGraph | None = None
        cluster: List[VariantBubble] = []
        cluster_ids: List[List[str]] = []
        base_paths = [0] if add_reference else []
        k1 = k - 1
        trusted = VariantBubble.trusted

        import os as _os

        CHUNK = int(_os.environ.get("PANGENIE_TPU_VCF_CHUNK", 32 << 20))
        pending = b""
        eof = False
        while not eof:
            block = fh.read(CHUNK)
            if block:
                pending += block
                cut = pending.rfind(b"\n")
                if cut < 0:
                    continue
                chunk, pending = pending[: cut + 1], pending[cut + 1:]
            else:
                eof = True
                chunk, pending = pending, b""
                if not chunk:
                    break
            # peel leading header lines (Python-identical validation)
            while chunk:
                if chunk[0] != 0x23:  # '#'
                    break
                eol = chunk.find(b"\n")
                if eol < 0:
                    line_b, chunk = chunk, b""
                else:
                    line_b, chunk = chunk[:eol], chunk[eol + 1:]
                line = line_b.decode("ascii", "replace").rstrip("\n")
                if line.startswith("##") or not line:
                    continue
                nr_samples = self._validate_header_line(line, add_reference)
                header_seen = True
            if not chunk:
                continue
            if not header_seen:
                return False  # data before header: Python semantics
            res = _native.parse_vcf_chunk(
                chunk, nr_samples, k, add_reference, chrom_names_b,
                chrom_seqs, prev_chrom, prev_end,
            )
            if res is None:
                return False
            prev_chrom = res.final_chrom
            prev_end = res.final_end

            n = res.n
            chrom_a = res.chrom.tolist()
            start_a = res.start.tolist()
            end_a = res.end.tolist()
            alt_off_a = res.alt_off.tolist()
            alt_len_a = res.alt_len.tolist()
            id_off_a = res.id_off.tolist()
            id_len_a = res.id_len.tolist()
            nundef_a = res.nundef.tolist()
            newcl_a = res.newcluster.tolist()
            paths_m = res.paths
            unc = res.uncovered
            for i in range(n):
                ci = chrom_a[i]
                if ci != cur_ci:
                    if cluster:
                        current_graph.add_variant_cluster(
                            cluster, cluster_ids, True
                        )
                        cluster = []
                        cluster_ids = []
                    if current_graph is not None:
                        self.graphs[cur_name] = current_graph
                    cur_ci = ci
                    cur_name = chrom_names[ci]
                    current_graph = ChromosomeGraph(
                        fasta_reader.extract_name(cur_name),
                        cur_name, k, add_reference,
                    )
                    cur_seq = chrom_seqs[ci]
                elif newcl_a[i] and cluster:
                    current_graph.add_variant_cluster(
                        cluster, cluster_ids, True
                    )
                    cluster = []
                    cluster_ids = []
                s = start_a[i]
                e = end_a[i]
                ao = alt_off_a[i]
                alleles = [cur_seq[s:e]] + chunk[
                    ao:ao + alt_len_a[i]
                ].upper().split(b",")
                nu = nundef_a[i]
                if nu:
                    alleles.extend([b"N"] * nu)
                io_ = id_off_a[i]
                ids = (
                    chunk[io_:io_ + id_len_a[i]].decode("ascii").split(",")
                    if io_ >= 0 else []
                )
                cluster.append(trusted(
                    cur_seq[s - k1:s], cur_seq[e:e + k1], cur_name, s, e,
                    alleles, base_paths + paths_m[i].tolist(),
                    [] if unc is None else unc[i],
                ))
                cluster_ids.append(ids)

        if not header_seen:
            raise RuntimeError("PanelBuilder: not a proper VCF-file.")
        if current_graph is not None:
            if cluster:
                current_graph.add_variant_cluster(cluster, cluster_ids, True)
            self.graphs[cur_name] = current_graph
        self._finalize_graphs()
        return True

    def _construct_graph_python(
        self, filename: str, fasta_reader: FastaReader, add_reference: bool
    ) -> None:
        try:
            file = open(filename, "r")
        except OSError as e:
            raise RuntimeError("PanelBuilder: input VCF file cannot be opened.") from e

        previous_chrom = ""
        previous_end_pos = 0
        nr_samples = 0  # set by the header line
        variant_cluster: List[VariantBubble] = []
        variant_cluster_ids: List[List[str]] = []
        current_graph: ChromosomeGraph | None = None
        header_seen = False

        from ..kmers import native as _native

        use_native_gt = _native.available()

        with file:
            for line in file:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line.startswith("##"):
                    continue
                # data rows: only fields 0-8 are tokenized; the GT
                # region (field 9+) parses as one block natively
                tokens = (
                    line.split("\t")
                    if line.startswith("#")
                    else line.split("\t", 9)
                )
                if line.startswith("#"):
                    if len(tokens) < 9:
                        raise RuntimeError("PanelBuilder: not a proper VCF-file.")
                    if len(tokens) < 10:
                        raise RuntimeError("PanelBuilder: no haplotype paths given.")
                    for i in range(9):
                        if tokens[i] != _VCF_FIELDS[i]:
                            raise RuntimeError(
                                "PanelBuilder: VCF header line is malformed."
                            )
                    nr_samples = len(tokens) - 9
                    self.nr_paths = nr_samples * 2
                    if add_reference:
                        self.nr_paths += 1
                    header_seen = True
                    continue
                if len(tokens) < 10:
                    raise RuntimeError(
                        "PanelBuilder: malformed VCF-file, or no haplotype paths given."
                    )
                current_chrom = tokens[0]
                current_start_pos = int(tokens[1]) - 1  # VCF is 1-based
                if previous_chrom == current_chrom and current_start_pos < previous_end_pos:
                    raise RuntimeError(
                        f"PanelBuilder: variant at {current_chrom}:{current_start_pos} "
                        "overlaps previous one. VCF does not represent a pangenome graph."
                    )

                ref = normalize_sequence(tokens[3])
                # after the first graph was created, the chromosome's
                # sequence lives in that graph's FastaReader
                if previous_chrom == current_chrom:
                    assert current_graph is not None
                    reader = current_graph.fasta_reader
                else:
                    reader = fasta_reader
                observed = reader.get_subsequence(
                    current_chrom, current_start_pos, current_start_pos + len(ref)
                )
                if ref != observed:
                    raise RuntimeError(
                        "PanelBuilder: REF allele in VCF does not match reference FASTA."
                    )
                current_end_pos = current_start_pos + len(ref)

                if not _ALT_PATTERN.match(tokens[4].encode("ascii")):
                    # skip records with symbolic / undefined ALT alleles
                    continue
                alleles: List[bytes] = [ref] + [
                    normalize_sequence(a) for a in tokens[4].split(",")
                ]
                if len(alleles) > 65535:
                    raise RuntimeError(
                        "PanelBuilder: number of alternative alleles is limited to 65534."
                    )

                size_of_chromosome = reader.get_size_of(current_chrom)
                # skip variants too close to the chromosome ends
                if (current_start_pos < self.kmer_size * 2) or (
                    current_end_pos + self.kmer_size * 2 > size_of_chromosome
                ):
                    continue

                # start a new cluster if the chromosome changed or the
                # variant is >= k-1 bases away from the previous one
                if previous_chrom != current_chrom or (
                    current_start_pos - previous_end_pos
                ) >= (self.kmer_size - 1):
                    if current_graph is not None:
                        current_graph.add_variant_cluster(
                            variant_cluster, variant_cluster_ids, True
                        )
                    variant_cluster = []
                    variant_cluster_ids = []
                    if previous_chrom != current_chrom:
                        if current_graph is not None:
                            self.graphs[previous_chrom] = current_graph
                        current_graph = ChromosomeGraph(
                            fasta_reader.extract_name(current_chrom),
                            current_chrom,
                            self.kmer_size,
                            add_reference,
                        )

                var_ids = _parse_info_ids(tokens[7])

                if self.nr_paths > 65535:
                    raise RuntimeError(
                        "PanelBuilder: number of paths is limited to 65534."
                    )

                # construct per-path alleles; each missing '.' haplotype
                # becomes its own new "N" allele. Faithful to the
                # reference (src/graphbuilder.cpp:216-242): genotype
                # fields are parsed with atoi semantics, so "0:150"
                # (GT:PS format) reads as allele 0 and ".:100" is NOT
                # treated as missing (atoi('.') == 0)
                paths: List[int] = []
                if add_reference:
                    paths.append(0)
                undefined_index = len(alleles)
                parsed = (
                    _native.parse_gt_line(
                        tokens[9].encode("ascii"), undefined_index,
                        nr_samples,
                    )
                    if use_native_gt
                    else None
                )
                if parsed is not None:
                    gt_paths, n_undef = parsed
                    paths.extend(gt_paths.tolist())
                    if n_undef:
                        alleles.extend([b"N"] * n_undef)
                        assert undefined_index + n_undef <= 65535
                    gt_tokens = []
                else:
                    gt_tokens = tokens[9].split("\t")
                for token in gt_tokens:
                    if "/" in token:
                        raise RuntimeError("PanelBuilder: found unphased genotype.")
                    a, sep, b = token.partition("|")
                    if not sep or "|" in b:
                        raise RuntimeError(
                            "PanelBuilder: genotypes must be diploid (.|. if missing)."
                        )
                    for s in (a, b):
                        if s == ".":
                            alleles.append(b"N")
                            paths.append(undefined_index)
                            assert undefined_index < 65535
                            undefined_index += 1
                        else:
                            p_index = _atoi(s)
                            if p_index >= len(alleles) or p_index < 0:
                                raise RuntimeError(
                                    "PanelBuilder: invalid genotype in VCF."
                                )
                            paths.append(p_index)

                assert current_graph is not None
                left_flank = current_graph.fasta_reader.get_subsequence(
                    current_chrom,
                    current_start_pos - self.kmer_size + 1,
                    current_start_pos,
                )
                right_flank = current_graph.fasta_reader.get_subsequence(
                    current_chrom,
                    current_end_pos,
                    current_end_pos + self.kmer_size - 1,
                )
                variant = VariantBubble(
                    left_flank,
                    right_flank,
                    current_chrom,
                    current_start_pos,
                    current_end_pos,
                    alleles,
                    paths,
                )
                variant_cluster.append(variant)
                variant_cluster_ids.append(var_ids)
                previous_chrom = current_chrom
                previous_end_pos = current_end_pos

        if not header_seen:
            raise RuntimeError("PanelBuilder: not a proper VCF-file.")
        if current_graph is not None:
            current_graph.add_variant_cluster(variant_cluster, variant_cluster_ids, True)
            self.graphs[previous_chrom] = current_graph
        self._finalize_graphs()

    # -- k-mer counting corpus -------------------------------------------

    def write_path_segments(self, filename: str, fasta_reader: FastaReader) -> None:
        """Write the graph k-mer corpus FASTA: reference unitigs between
        bubbles + all allele sequences (with flanks) per bubble.

        (reference src/graphbuilder.cpp:293-353)
        """
        with open(filename, "w") as out:
            vcf_chromosomes = set(self.graphs.keys())
            # VCF chromosomes first (size-descending, as ordered by
            # construction), then FASTA-only chromosomes
            all_names = list(self.chromosomes) + [
                n for n in fasta_reader.get_names() if n not in vcf_chromosomes
            ]
            for element in all_names:
                if element in vcf_chromosomes:
                    graph = self.graphs[element]
                    if graph.variants_were_deleted():
                        raise RuntimeError(
                            "PanelBuilder.write_path_segments: variants were deleted."
                        )
                    reader = graph.fasta_reader
                    chrom_seq = reader.get_sequence(element)
                    prev_end = 0
                    parts: List[str] = []
                    for i in range(graph.size()):
                        variant = graph.get_variant(i)
                        start_pos = variant.start_position
                        parts.append(f">{element}_reference_{start_pos}\n")
                        parts.append(
                            chrom_seq[prev_end:start_pos].decode("ascii")
                        )
                        parts.append("\n")
                        seqs, _undef = variant.selection_alleles()
                        for allele, seq in enumerate(seqs):
                            parts.append(f">{element}_{start_pos}_{allele}\n")
                            parts.append(seq.decode("ascii"))
                            parts.append("\n")
                        prev_end = variant.get_end_position()
                        if len(parts) >= 4096:
                            out.write("".join(parts))
                            parts = []
                    out.write("".join(parts))
                    out.write(f">{element}_reference_end\n")
                    chr_len = reader.get_size_of(element)
                    out.write(
                        reader.get_subsequence(element, prev_end, chr_len).decode("ascii")
                        + "\n"
                    )
                else:
                    out.write(f">{element}_reference_end\n")
                    chr_len = fasta_reader.get_size_of(element)
                    out.write(
                        fasta_reader.get_subsequence(element, 0, chr_len).decode("ascii")
                        + "\n"
                    )

    def get_chromosomes(self) -> List[str]:
        return list(self.chromosomes)

    def nr_of_paths(self) -> int:
        return self.nr_paths

    def get_kmer_size(self) -> int:
        return self.kmer_size
