"""VCF 4.2 serialization.

The writer is organized as a declarative header vocabulary (tables below)
plus a staged record emitter: genotype columns -> INFO assembly -> allele
materialization (DEL sequence resolution, anchor-base prefixing, IUPAC
cleanup) -> line write.  Byte-level output matches the reference writer
(reference: vcf.py:25-481).  Reference FASTA access goes through the
built-in io/fasta.py rather than pysam.  Copied from
sniffles_tpu/io/vcf.py; the force-calling reader and re-writer belong to
the genotype_vcf mode, which is not part of the combine slice.
"""
from __future__ import annotations

import logging
import os

from sniffles_tpu_torch import svcall as sv
from sniffles_tpu_torch.util import ambiguity_cleanup_table

log = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Header vocabulary.  Emitted verbatim, in table order, one ##-line each
# (reference: vcf.py:121-207).  Entries guarded by a config attribute carry
# it as the third tuple element.

_ALT_LINES = (
    'ALT=<ID=INS,Description="Insertion">',
    'ALT=<ID=DEL,Description="Deletion">',
    'ALT=<ID=DUP,Description="Duplication">',
    'ALT=<ID=INV,Description="Inversion">',
    'ALT=<ID=BND,Description="Breakend; Translocation">',
)

_FORMAT_FIELDS = (
    ("GT", "String", "Genotype"),
    ("GQ", "Integer", "Genotype quality"),
    ("DR", "Integer", "Number of reference reads"),
    ("DV", "Integer", "Number of variant reads"),
    ("PS", "Integer", "Phase-block, zero if none or not phased"),
    ("ID", "String", "Individual sample SV ID for multi-sample output"),
)

_FILTER_DESCRIPTIONS = (
    ("PASS", "All filters passed"),
    ("GT", "Genotype filter"),
    ("SUPPORT_MIN", "Minimum read support filter"),
    ("STDEV_POS", "SV Breakpoint standard deviation filter"),
    ("STDEV_LEN", "SV length standard deviation filter"),
    ("COV_MIN", "Minimum coverage filter"),
    ("COV_MIN_GT", "Minimum coverage filter (missing genotype)"),
    ("COV_CHANGE_DEL", "Coverage change filter for DEL"),
    ("COV_CHANGE_DUP", "Coverage change filter for DUP"),
    ("COV_CHANGE_INS", "Coverage change filter for INS"),
    ("COV_CHANGE_FRAC_US", "Coverage fractional change filter: upstream-start"),
    ("COV_CHANGE_FRAC_SC", "Coverage fractional change filter: start-center"),
    ("COV_CHANGE_FRAC_CE", "Coverage fractional change filter: center-end"),
    ("COV_CHANGE_FRAC_ED", "Coverage fractional change filter: end-downstream"),
    ("COV_VAR", "Coverage variance exceeded"),
    ("MOSAIC_VAF", "Mosaic variant allele fraction filter"),
    ("NOT_MOSAIC_VAF", "Variant allele fraction filter for non-mosaic"),
    ("ALN_NM", "Length adjusted mismatch filter"),
    ("STRAND_BND", "Strand support filter for BNDs"),
    ("STRAND", "Strand support filter for germline SVs"),
    ("STRAND_MOSAIC", "Strand support filter for mosaic SVs"),
    ("SVLEN_MIN", "SV length filter"),
    ("SVLEN_MIN_MOSAIC", "SV length filter for mosaic SVs (min)"),
    ("SVLEN_MAX_MOSAIC", "SV length filter for mosaic SVs (max)"),
    ("SINGLE_BREAK", "A single break point was detected but not classified as an SV."),
    ("INLINE_SA", "INLINE/CIGAR-based SV is mostly supported by SA reads"),
    ("MOSAIC_SV_CLOSE_EDGE", "For mosaic SVs, the location is close to the end of the read (either end)"),
    ("GT_FAILED", "Unable to genotype this call."),
)

# (id, Number, Type, Description, config gate or None)
_INFO_FIELDS = (
    ("PRECISE", "0", "Flag", "Structural variation with precise breakpoints", None),
    ("IMPRECISE", "0", "Flag", "Structural variation with imprecise breakpoints", None),
    ("MOSAIC", "0", "Flag", "Structural variation classified as putative mosaic", None),
    ("SVLEN", "1", "Integer", "Length of structural variation", None),
    ("SVLENGTHS", ".", "Integer", "Lengths of structural variation (all)", "dev_emit_sv_lengths"),
    ("SVTYPE", "1", "String", "Type of structural variation", None),
    ("CHR2", "1", "String", "Mate chromsome for BND SVs", None),
    ("SUPPORT", "1", "Integer", "Number of reads supporting the structural variation", None),
    ("SUPPORT_INLINE", "1", "Integer", "Number of reads supporting an INS/DEL SV (non-split events only)", None),
    ("SUPPORT_SA", "1", "Integer", "Number of reads supporting a DEL SV through supplementary alignments (split events)", None),
    ("SUPPORT_LONG", "1", "Integer", "Number of soft-clipped reads putatively supporting the long insertion SV", None),
    ("END", "1", "Integer", "End position of structural variation", None),
    ("STDEV_POS", "1", "Float", "Standard deviation of structural variation start position", None),
    ("STDEV_LEN", "1", "Float", "Standard deviation of structural variation length", None),
    ("COVERAGE", ".", "Float", "Coverages near upstream, start, center, end, downstream of structural variation", None),
    ("STRAND", "1", "String", "Strands of supporting reads for structural variant", None),
    ("AC", ".", "Integer", "Allele count, summed up over all samples", None),
    ("SUPP_VEC", "1", "String", "List of read support for all samples", None),
    ("CONSENSUS_SUPPORT", "1", "Integer", "Number of reads that support the generated insertion (INS) consensus sequence", None),
    ("RNAMES", ".", "String", "Names of supporting reads (if enabled with --output-rnames)", None),
    ("VAF", "1", "Float", "Variant Allele Fraction", None),
    ("COVERAGE_VAR", "1", "Float", "Variance of coverage across large events", None),
    ("NM", ".", "Float", "Mean number of query alignment length adjusted mismatches of supporting reads", None),
    ("PHASE", ".", "String", "Phasing information derived from supporting reads, represented as list of: "
                             "HAPLOTYPE,PHASESET,HAPLOTYPE_SUPPORT,PHASESET_SUPPORT,HAPLOTYPE_FILTER,PHASESET_FILTER", None),
    ("LASM", "0", "Flag", "Local assembly used to detect the structural variant", None),
    ("POPULATION_AF", "1", "Float", "Population Allele Frequency", "combine_population"),
    ("POPULATION_SIZE", "1", "Integer", "Size of genotyped population for this variant", "combine_population"),
)

def format_info(k, v):
    """One INFO token: floats to 3 decimals, lists comma-joined, true flags
    bare, None as '.' (reference: vcf.py:25-35)."""
    if isinstance(v, float):
        return f"{k}={v:.3f}"
    if isinstance(v, list):
        return k + "=" + ",".join(v)
    if v is True:
        return k
    return f"{k}={'.' if v is None else v}"


def unpack_phase(phase, svid="") -> tuple:
    """Split a phase annotation into (haplotype, phase-set), tolerating
    bare scalars and None (reference: vcf.py:38-48)."""
    try:
        hap, block = phase
    except TypeError:
        if phase is not None:
            log.debug(f"Single not 'None'-valued phase: {phase}|{svid}")
        hap, block = phase, "."
    if block is None or block == "NULL":
        block = "."
    return hap, block


def format_genotype(gt, is_phased):
    """One genotype column.  6-tuple = single-sample, 7-tuple carries a
    trailing per-sample SV id (combine mode); the PS field appears only in
    phased output (reference: vcf.py:51-79)."""
    a, b, quality, ref_reads, var_reads, phase = gt[:6]
    has_svid = len(gt) > 6
    hap, block = unpack_phase(phase, gt[6] if has_svid else "")
    if is_phased and hap is not None and (a, b) in ((0, 1), (1, 1)):
        if hap == "1":
            a, b = b, a
        allele_str = f"{a}|{b}"
    else:
        allele_str = f"{a}/{b}"
    column = [allele_str, quality, ref_reads, var_reads]
    if is_phased:
        column.append(block)
    if has_svid:
        column.append(gt[6])
    return ":".join(str(c) for c in column)


class VCF:
    """VCF writer bound to one output handle
    (reference: vcf.py:82-481)."""

    def __init__(self, config, handle):
        self.config = config
        self.handle = handle
        self.call_count = 0
        self.reference_handle = None

        # Per-record INFO emission order; gated fields mirror the header gates.
        order = ["SVTYPE", "SVLEN", "END", "SUPPORT", "RNAMES", "COVERAGE", "STRAND"]
        for field, wanted in (("NM", config.qc_nm_measure),
                              ("SVLENGTHS", config.dev_emit_sv_lengths)):
            if wanted:
                order.append(field)
        self.info_order = order

        fmt, placeholder = config.genotype_format, config.genotype_none
        if config.phase:
            fmt += ":PS"
        if config.mode == "combine":
            fmt, placeholder = fmt + ":ID", placeholder + ("NULL",)
        self.genotype_format, self.default_genotype = fmt, placeholder

    # -- header ------------------------------------------------------------

    def write_raw(self, text, endl="\n"):
        self.handle.write(text + endl)

    def write_header_line(self, text):
        self.write_raw(f"##{text}")

    def _gate_open(self, gate) -> bool:
        return gate is None or bool(getattr(self.config, gate, False))

    def write_header(self, contigs_lengths):
        cfg = self.config
        preamble = [
            "fileformat=VCFv4.2",
            f"source={cfg.version}_{cfg.build}",
            f'command="{cfg.command}"',
            f'fileDate="{cfg.start_date}"',
        ]
        preamble += [f"contig=<ID={name},length={length}>" for name, length in contigs_lengths]
        preamble += list(_ALT_LINES)
        preamble += [f'FORMAT=<ID={fid},Number=1,Type={ftype},Description="{desc}">'
                     for fid, ftype, desc in _FORMAT_FIELDS]
        preamble += [f'FILTER=<ID={fid},Description="{desc}">'
                     for fid, desc in _FILTER_DESCRIPTIONS]
        preamble += [f'INFO=<ID={iid},Number={num},Type={typ},Description="{desc}">'
                     for iid, num, typ, desc, gate in _INFO_FIELDS
                     if self._gate_open(gate)]
        for line in preamble:
            self.write_header_line(line)
        sample_names = "\t".join(name for _, name in cfg.sample_ids_vcf)
        self.write_raw(f"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t{sample_names}")

    def open_reference(self, generate_index: bool = True):
        if self.config.reference is None:
            return
        from sniffles_tpu_torch.io.fasta import FastaFile, build_fai
        have_index = (os.path.exists(self.config.reference + ".fai")
                      or os.path.exists(self.config.reference + ".gzi"))
        if not have_index and generate_index:
            log.warning(f"Fasta index for {self.config.reference} not found. Generating "
                        f"(this may take a while)")
            build_fai(self.config.reference)
        try:
            self.reference_handle = FastaFile(self.config.reference)
        except Exception:
            log.error(f'Unable to open reference file {self.config.reference}')

    # -- record emission ---------------------------------------------------

    def _genotype_columns(self, call):
        """Render one column per output sample; returns (columns, allele
        count, support vector string) (reference: vcf.py:230-243)."""
        columns = []
        alleles = 0
        bits = []
        for sample_key, _ in self.config.sample_ids_vcf:
            gt = call.genotypes.get(sample_key) if call.genotypes else None
            if gt is None:
                columns.append(format_genotype(self.default_genotype, self.config.phase))
                bits.append("0")
                continue
            columns.append(format_genotype(gt, self.config.phase))
            if gt[0] != "." and gt[4] > 0:
                alleles += gt[0] + gt[1]
                bits.append("1")
            else:
                bits.append("0")
        return columns, alleles, "".join(bits)

    def _assemble_info(self, call, end):
        """Build the ordered INFO string: precision flag, optional MOSAIC,
        the fixed-order core fields, then remaining info keys sorted
        (reference: vcf.py:266-302)."""
        cfg = self.config
        strand_tag = ("+" if call.fwd > 0 else "") + ("-" if call.rev > 0 else "")
        span = (f"{call.coverage_upstream},{call.coverage_start},{call.coverage_center},"
                f"{call.coverage_end},{call.coverage_downstream}")
        core = {
            "SVTYPE": call.svtype,
            "SVLEN": call.svlen,
            "SVLENGTHS": ",".join(str(n) for n in call.svlens) if call.svlens else None,
            "END": end,
            "SUPPORT": call.support,
            "RNAMES": call.rnames if cfg.output_rnames else None,
            "COVERAGE": span,
            "STRAND": strand_tag,
            "NM": call.nm,
        }
        if call.svtype == "BND":
            core["SVLEN"] = core["SVLENGTHS"] = core["END"] = None

        tokens = ["PRECISE" if call.precise else "IMPRECISE"]
        vaf = call.get_info("VAF") or 0
        if cfg.mosaic and vaf <= cfg.mosaic_af_max:
            tokens.append("MOSAIC")
        tokens += [format_info(key, core[key]) for key in self.info_order
                   if core[key] is not None]
        tokens += [format_info(key, call.info[key]) for key in sorted(call.info)
                   if call.info[key] is not None]
        return ";".join(tokens)

    def _materialize_del_sequence(self, call, pos) -> bool:
        """Try to replace a symbolic DEL with its literal reference bases.
        Returns False when the call must be suppressed because the deleted
        span is mostly N (reference: vcf.py:304-321)."""
        try:
            # The base before the event anchors the REF allele per VCF 4.2.
            call.ref = self.reference_handle.fetch(call.contig, call.pos - 1, call.pos - call.svlen)
            call.alt = call.ref[0]
        except (KeyError, ValueError):
            call.ref = "N"
            call.alt = f"<{call.svtype}>"
            return True
        n_count = call.ref.count('N')
        if n_count and n_count / len(call.ref) > self.config.max_unknown_pct:
            log.debug(f'Not emitting {call.id} in {call.contig}:{call.pos} (length '
                      f'{call.svlen}) due to {n_count / len(call.ref) * 100:.2f}% N bases in reference.')
            return False
        return True

    def _materialize_alleles(self, call, pos) -> bool:
        """Final REF/ALT resolution: literal DEL sequences, symbolic-mode
        collapse, anchor-base prefixing for INS/BND, IUPAC cleanup.
        Returns False if the record should be dropped
        (reference: vcf.py:304-342)."""
        cfg = self.config
        if (call.svtype == "DEL" and not cfg.symbolic and self.reference_handle is not None
                and abs(call.svlen) <= cfg.max_del_seq_len):
            if not self._materialize_del_sequence(call, pos):
                return False

        if cfg.symbolic:
            call.ref = "N"
            if call.svtype != "BND":
                call.alt = f"<{call.svtype}>"
            return True

        if self.reference_handle is not None and call.ref == 'N':
            anchor_at = max(0, call.pos - 1)
            try:
                anchor = self.reference_handle.fetch(call.contig, anchor_at, anchor_at + 1)
            except (KeyError, ValueError):
                pass
            else:
                call.ref = anchor
                if call.svtype == "INS" and call.alt != '<INS>':
                    call.alt = anchor + call.alt
                elif call.svtype == 'BND' and call.alt != '<BND>':
                    # The anchor base replaces the placeholder N on whichever
                    # side of the bracket notation this breakend anchors.
                    call.alt = (anchor + call.alt[1:] if call.alt.startswith('N')
                                else call.alt[:-1] + anchor)
            call.ref = call.ref.translate(ambiguity_cleanup_table)
            # Symbolic alts (e.g. <INS>) are exempt: translating would corrupt
            # the symbol ('S' -> 'N'), per the reference's own regression test
            # for issue #501 (reference: src/tests/test_vcf.py:198-221).
            if not call.alt.startswith('<'):
                call.alt = call.alt.translate(ambiguity_cleanup_table)
        return True

    def write_call(self, call: sv.SVCall) -> int:
        """Emit one record; returns the number of lines written (0 when the
        call is suppressed) (reference: vcf.py:216-350)."""
        if call.is_single_break:
            return 0

        cfg = self.config
        pos = call.pos if call.pos > 0 else 1
        end = pos + abs(call.svlen) if (call.precise and call.svtype == 'DEL') else call.end

        columns, allele_count, support_vector = self._genotype_columns(call)

        if len(cfg.sample_ids_vcf) > 1:
            call.set_info("AC", allele_count)
            call.set_info("SUPP_VEC", support_vector)
            if int(support_vector) == 0:
                log.debug(f'Dropped {call} due to all zero support vector.')
                return 0
            if allele_count == 0:
                call.filter = "GT"

        if call.svtype == "INS":
            if call.svlen != len(call.alt) and not cfg.symbolic and call.alt != "<INS>":
                call.svlen = len(call.alt)
            if call.svlen < cfg.minsvlen:
                return 0

        info_str = self._assemble_info(call, end)

        if not self._materialize_alleles(call, pos):
            return 0

        if call.qual is not None:
            call.qual = max(0, min(60, call.qual))

        fields = [call.contig, pos, cfg.id_prefix + call.id, call.ref, call.alt,
                  call.qual if call.qual is not None else '.', call.filter,
                  info_str, self.genotype_format, *columns]
        self.write_raw("\t".join(str(f) for f in fields))
        self.call_count += 1
        return 1

    def close(self):
        self.handle.close()
