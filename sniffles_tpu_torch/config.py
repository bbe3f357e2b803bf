"""Configuration and flag system.

The full flag surface is declared as data: one table entry per flag,
grouped exactly as the reference groups them, since flag names and
defaults are load-bearing for output equivalence (reference:
config.py:103-619).  A registration loop materializes the argparse
parser from the tables; post-parse derivation is organized as a chain
of small methods.  A copy of sniffles_tpu/config.py with the same flags
and defaults; only the device rule differs (torch_device below).
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys
import tempfile
from collections import defaultdict
from functools import cached_property
from typing import Optional, Union, Literal, TYPE_CHECKING

from sniffles_tpu_torch import util, VERSION, BUILD, SNF_VERSION
from sniffles_tpu_torch.region import Region

if TYPE_CHECKING:
    from sniffles_tpu_torch.io.snfp import PopulationSNF


# --------------------------------------------------------------------------
# Two-level help machinery: flags marked BASIC show in plain --help; the
# rest only under --expert-help (reference: config.py:34-89).

BASIC, ADV = True, False


class Basic(str):
    """Help-text wrapper marking a flag as part of the basic help page."""


class _HelpStyle(argparse.ArgumentDefaultsHelpFormatter,
                 argparse.RawDescriptionHelpFormatter):
    pass


class _BasicOnlyStyle(_HelpStyle):
    def add_argument(self, action):
        if isinstance(action.help, Basic):
            super().add_argument(action)


class _EverythingStyle(_HelpStyle):
    def add_argument(self, action):
        if not isinstance(action.help, Basic) and action.help is not argparse.SUPPRESS:
            action.help = f"{action.help} (expert)"
        super().add_argument(action)


class _ExpertHelp(argparse._HelpAction):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.print_help(expert=True)
        parser.exit()


class LayeredHelpParser(argparse.ArgumentParser):
    """ArgumentParser whose --help shows only Basic-marked flags and whose
    --expert-help shows everything."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register('action', 'expert-help', _ExpertHelp)
        self.add_argument(
            "--expert-help", action=_ExpertHelp,
            help="Show help for all parameters, including expert options "
                 "(default: only basic help is shown).")

    def print_help(self, expert: bool = False):
        style = _EverythingStyle if expert else _BasicOnlyStyle
        self.formatter_class = lambda prog: style(prog, max_help_position=100, width=150)
        return super().print_help()


def tobool(v):
    if v is True or v is False:
        return v
    token = v.strip().lower()
    if token in ("true", "1"):
        return True
    if token in ("false", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value (True | False) required for argument")


# --------------------------------------------------------------------------
# Flag tables.  Entry = (option strings, help text (None = hidden), level,
# add_argument keyword dict).  Values mirror the reference definitions
# (reference: config.py:173-444); the TPU group is new.

def _f(*names, text=None, level=ADV, **kw):
    return (names, text, level, kw)


_COMMON_FLAGS = (
    _f("-i", "--input", text="For single-sample calling: A coordinate-sorted and indexed .bam/.cram (BAM/CRAM format) file containing aligned reads. - OR - For multi-sample calling: Multiple .snf files (generated before by running sniffles-tpu for individual samples with --snf)", level=BASIC, metavar="IN", type=str, required=True, nargs="+"),
    _f("-v", "--vcf", text="VCF output filename to write the called and refined SVs to. If the given filename ends with .gz, the VCF file will be automatically bgzipped and a .tbi index built for it.", level=BASIC, metavar="OUT.vcf", type=str, required=False),
    _f("--snf", text="SNF output filename to store candidates for later multi-sample calling", level=BASIC, metavar="OUT.snf", type=str, required=False),
    _f("--reference", text="(Optional) Reference sequence the reads were aligned against. To enable output of deletion SV sequences, this parameter must be set.", level=BASIC, metavar="reference.fasta", type=str, default=None),
    _f("--phase", text="Determine phase for SV calls (requires the input alignments to be phased)", level=BASIC, default=argparse.SUPPRESS, action="store_true"),
    _f("-t", "--threads", text="Number of parallel host threads to use", level=BASIC, metavar="N", type=int, default=4),
    _f("-c", "--contig", text="(Optional) Only process the specified contigs. May be given more than once.", level=BASIC, default=None, type=str, action="append"),
    _f("--regions", text="(Optional) Only process the specified regions.", level=BASIC, metavar="REGIONS.bed", type=str, default=None),
    _f("--region", metavar="contig:start-stop", type=str, default=None, action="append"),
    _f("--tmp-dir", text="(Optional) Directory where temporary files are written, must exist. If it doesn't, default path is used", level=BASIC, type=str, default=""),
    _f("--all-contigs", text="(Optional) Process all contigs in the input file including small ones.", level=BASIC, action="store_true", default=False),
)

_FILTER_FLAGS = (
    _f("--minsupport", text="Minimum number of supporting reads for a SV to be reported (default: automatically choose based on coverage)", metavar="auto", type=str, default="3"),
    _f("--minsupport-auto-mult", text="Coverage based minimum support multiplier for germline mode (only for auto minsupport) ", metavar="0.1/0.025", type=float, default=None),
    _f("--minsvlen", text="Minimum SV length (in bp). May be prefixed with tilde (e.g. ~50) to allow for slightly smaller SVs if strongly supported.", level=BASIC, metavar="N", type=str, default="~50"),
    _f("--minsvlen-screen-ratio", text="Minimum length for SV candidates (as fraction of --minsvlen)", metavar="N", type=float, default=0.9),
    _f("--mapq", text="Alignments with mapping quality lower than this value will be ignored", level=BASIC, metavar="N", type=int, default=argparse.SUPPRESS),
    _f("--no-qc", "--qc-output-all", text="Output all SV candidates, disregarding quality control steps.", level=BASIC, default=False, action="store_true"),
    _f("--pass-only", text="Output only SVs that pass all quality control steps, including GT.", default=False, action="store_true"),
    _f("--qc-stdev", text="Apply filtering based on SV start position and length standard deviation", metavar="True", type=tobool, default=True),
    _f("--qc-stdev-abs-max", text="Maximum standard deviation for SV length and size (in bp)", metavar="N", type=int, default=500),
    _f("--qc-strand", text="Apply filtering based on strand support of SV calls", metavar="False", type=tobool, default=False),
    _f("--qc-coverage", text="Minimum surrounding region coverage of SV calls", metavar="N", type=int, default=1),
    _f("--long-ins-length", text="Insertion SVs longer than this value are considered as hard to detect based on the aligner and read length and subjected to more sensitive filtering.", metavar="2500", type=int, default=2500),
    _f("--long-del-length", text="Deletion SVs longer than this value are subjected to central coverage drop-based filtering (Not applicable for --mosaic)", metavar="50000", type=int, default=50000),
    _f("--long-inv-length", text="Inversion SVs longer than this value are not subjected to central coverage drop-based filtering", metavar="10000", type=int, default=10000),
    _f("--long-del-coverage", text="Long deletions with central coverage (in relation to upstream/downstream coverage) higher than this value will be filtered (Not applicable for --mosaic)", metavar="0.66", type=float, default=0.66),
    _f("--long-dup-length", text="Duplication SVs longer than this value are subjected to central coverage increase-based filtering (Not applicable for --mosaic)", metavar="50000", type=int, default=50000),
    _f("--long-dup-coverage", text="Long duplications with central coverage (in relation to upstream/downstream coverage) lower than this value will be filtered (Not applicable for --mosaic)", metavar="1.33", type=float, default=1.33),
    _f("--qc-bnd-filter-strand", text="Filter breakends that do not have support for both strands", type=tobool, default=True),
    _f("--bnd-min-split-length", text="Minimum length of read splits to be considered for breakends", type=int, default=1000),
    _f("--max-splits-kb", text="Additional number of splits per kilobase read sequence allowed before reads are ignored", metavar="N", type=float, default=0.1),
    _f("--max-splits-base", text="Base number of splits allowed before reads are ignored (in addition to --max-splits-kb)", metavar="N", type=int, default=3),
    _f("--min-alignment-length", text="Reads with alignments shorter than this length (in bp) will be ignored", metavar="N", type=int, default=argparse.SUPPRESS),
    _f("--phase-conflict-threshold", text="Maximum fraction of conflicting reads permitted for SV phase information to be labelled as PASS (only for --phase)", metavar="F", type=float, default=0.1),
    _f("--detect-large-ins", text="Infer insertions that are longer than most reads and therefore are spanned by few alignments only.", metavar="True", type=tobool, default=True),
    _f("--max-unknown-pct", text="Maximum percentage of N for an SV to be emitted.", metavar="0.5", type=float, default=0.5),
    _f("--large-coverage-sample-interval", text="Sampling interval for coverage calculation for large SVs", metavar="5000", type=int, default=5000),
)

_CLUSTER_FLAGS = (
    _f("--cluster-binsize", text="Initial screening bin size in bp", metavar="N", type=int, default=100),
    _f("--cluster-r", text="Multiplier for SV start position standard deviation criterion in cluster merging", metavar="R", type=float, default=2.5),
    _f("--cluster-repeat-h", text="Multiplier for mean SV length criterion for tandem repeat cluster merging", metavar="H", type=float, default=1.5),
    _f("--cluster-repeat-h-max", text="Max. merging distance based on SV length criterion for tandem repeat cluster merging", metavar="N", type=float, default=1000),
    _f("--cluster-merge-pos", text="Max. merging distance for insertions and deletions on the same read and cluster in non-repeat regions", metavar="N", type=int, default=150),
    _f("--cluster-merge-len", text="Max. size difference for merging SVs as fraction of SV length. Germline and mosaic have different threholds", metavar="F", type=float, default=0.22),
    _f("--cluster-merge-bnd", text="Max. merging distance for breakend SV candidates.", metavar="N", type=int, default=1000),
)

_GENOTYPE_FLAGS = (
    _f("--genotype-ploidy", text="Sample ploidy (currently fixed at value 2)", metavar="N", type=int, default=2),
    _f("--genotype-error", text="Estimated false positive rate for leads (relating to total coverage)", metavar="N", type=float, default=0.05),
    _f("--sample-id", text="Custom ID for this sample, used for later multi-sample calling (stored in .snf)", type=str, default=None),
    _f("--genotype-vcf", text="Determine the genotypes for all SVs in the given input .vcf file (forced calling). Re-genotyped .vcf will be written to the output file specified with --vcf.", metavar="IN.vcf", type=str, default=None),
)

_COMBINE_FLAGS = (
    _f("--combine-high-confidence", text="Minimum fraction of samples in which a SV needs to have individually passed QC for it to be reported in combined output (a value of zero will report all SVs that pass QC in at least one of the input samples)", metavar="F", type=float, default=0.0),
    _f("--combine-low-confidence", text="Minimum fraction of samples in which a SV needs to be present (failed QC) for it to be reported in combined output", metavar="F", type=float, default=0.2),
    _f("--combine-low-confidence-abs", text="Minimum absolute number of samples in which a SV needs to be present (failed QC) for it to be reported in combined output", metavar="N", type=int, default=2),
    _f("--combine-null-min-coverage", text="Minimum coverage for a sample genotype to be reported as 0/0 (sample genotypes with coverage below this threshold at the SV location will be output as ./.)", metavar="N", type=int, default=5),
    _f("--combine-match", text="Multiplier for maximum deviation of multiple SV's start/end position for them to be combined across samples. Given by max_dev=M*sqrt(min(SV_length_a,SV_length_b)), where M is this parameter.", metavar="N", type=int, default=250),
    _f("--combine-match-max", text="Upper limit for the maximum deviation computed for --combine-match, in bp.", metavar="N", type=int, default=1000),
    _f("--combine-separate-intra", text="Disable combination of SVs within the same sample", default=False, action="store_true"),
    _f("--combine-output-filtered", text="Include low-confidence / mosaic SVs in multi-calling", default=False, action="store_true"),
    _f("--combine-pair-relabel", text="Override low-quality genotypes when combining 2 samples (may be used for e.g. tumor-normal comparisons)", default=False, action="store_true"),
    _f("--combine-pair-relabel-threshold", text="Genotype quality below which a genotype call will be relabeled", default=20, type=int),
    _f("--combine-close-handles", text="Close .SNF file handles after each use. May lower performance, but may be required when maximum number of file handles supported by OS is reached when merging many samples.", default=False, action="store_true"),
    _f("--combine-pctseq", text="Minimum alignment distance as percent of SV length to be merged. Set to 0 to disable alignments for merging.", level=BASIC, default=0.7, type=float),
    _f("--combine-max-inmemory-results", text="Maximum number of .snf input files to keep results in memory for. If the number of input files exceeds this value, --no-sort should be given as well to keep the output in a single file.", level=BASIC, default=20, type=int),
    _f("--combine-support-threshold", text="Minimum support for SVs to be considered for multi-sample calling.", default=3, metavar="N", type=int),
    _f("--combine-population", text="Name of a population SNF to enable population annotation.", level=BASIC, metavar="population.snf", type=str),
    _f("--re-qc", text="Re-QC SVs from SNF files. Set to 0 to disable re-qc of SNF files. Set to 1 to force re-qc. Default of 'auto' will try to fix known errors in SNF files.", metavar="auto", default="auto", type=str),
)

_POSTPROCESS_FLAGS = (
    _f("--output-rnames", text="Output names of all supporting reads for each SV in the RNAMEs info field", level=BASIC, default=False, action="store_true"),
    _f("--no-consensus", text="Disable consensus sequence generation for insertion SV calls (may improve performance)", default=False, action="store_true"),
    _f("--no-sort", text="Do not sort output VCF by genomic coordinates (may slightly improve performance)", level=BASIC, default=False, action="store_true"),
    _f("--no-progress", text="Disable progress display", default=False, action="store_true"),
    _f("--quiet", text="Disable all logging, except errors", default=False, action="store_true"),
    _f("--max-del-seq-len", text="Maximum deletion sequence length to be output. Deletion SVs longer than this value will be written to the output as symbolic SVs.", level=BASIC, metavar="N", type=int, default=50000),
    _f("--symbolic", text="Output all SVs as symbolic, including insertions and deletions, instead of reporting nucleotide sequences.", level=BASIC, default=False, action="store_true"),
    _f("--allow-overwrite", text="Allow overwriting output files if already existing", level=BASIC, default=False, action="store_true"),
)

_MOSAIC_FLAGS = (
    _f("--mosaic", text="Set run mode to detect rare, somatic and mosaic SVs", level=BASIC, default=False, action="store_true"),
    _f("--mosaic-af-max", text="Maximum allele frequency for which SVs are considered mosaic", metavar="F", default=0.218, type=float),
    _f("--mosaic-af-min", text="Minimum allele frequency for mosaic SVs to be output", level=BASIC, metavar="F", default=0.05, type=float),
    _f("--mosaic-qc-invdup-min-length", text="Minimum SV length for mosaic inversion and duplication SVs", metavar="N", default=500, type=int),
    _f("--mosaic-qc-nm", default=True, action="store_true"),
    _f("--mosaic-qc-nm-mult", metavar="F", type=float, default=1.66),
    _f("--mosaic-qc-coverage-max-change-frac", text="Maximum relative coverage change across SV breakpoints", metavar="F", type=float, default=-1),
    _f("--mosaic-qc-strand", text="Apply filtering based on strand support of SV calls", metavar="True", type=tobool, default=True),
    _f("--mosaic-include-germline", text="Report germline SVs as well in mosaic mode", level=BASIC, default=False, action="store_true"),
    _f("--max-svlen-mosaic", text="Maximum size of reported mosaic SV", metavar="N", type=int, default=50000),
)

_DEV_FLAGS = (
    _f("--tandem-repeats", text="(Optional) Input .bed file containing tandem repeat annotations for the reference genome.", level=BASIC, metavar="IN.bed", type=str, default=None),
    _f("--dev-emit-sv-lengths", default=False, action="store_true"),
    _f("--dev-cache", default=False, action="store_true"),
    _f("--dev-cache-dir", metavar="PATH", type=str, default=None),
    _f("--dev-debug-svtyping", default=False, action="store_true"),
    _f("--dev-keep-lowqual-splits", default=False, action="store_true"),
    _f("--dev-dump-clusters", default=False, action="store_true"),
    _f("--dev-merge-inline", default=False, action="store_true"),
    _f("--dev-seq-cache-maxlen", metavar="N", type=int, default=50000),
    _f("--dev-device-hedge-s", metavar="S", type=float, default=3.0,
       text="Accepted for compatibility with the sniffles_tpu package; no "
            "effect in this package, which never reroutes a slow device "
            "response to the host."),
    _f("--dev-combine-greedy-min", metavar="N", type=int, default=8,
       text="Minimum candidates per (block, svtype) before --tpu-combine "
            "dispatches the device greedy kernel (smaller blocks run the "
            "host greedy; dispatch latency would dominate)."),
    _f("--consensus-max-reads", metavar="N", type=int, default=20),
    _f("--consensus-max-reads-bin", metavar="N", type=int, default=10),
    _f("--combine-consensus", default=False, action="store_true"),
    _f("--dev-dump-coverage", default=False, action="store_true"),
    _f("--dev-no-resplit", default=False, action="store_true"),
    _f("--dev-no-resplit-repeat", default=False, action="store_true"),
    _f("--dev-skip-snf-validation", default=False, action="store_true"),
    _f("--low-memory", default=False, action="store_true"),
    _f("--repeat", default=False, action="store_true"),
    _f("--qc-nm", default=False, action="store_true"),
    _f("--qc-nm-mult", metavar="F", type=float, default=1.66),
    _f("--qc-coverage-max-change-frac", metavar="F", type=float, default=-1),
    _f("--coverage-updown-bins", metavar="N", type=int, default=5),
    _f("--coverage-shift-bins", metavar="N", type=int, default=3),
    _f("--coverage-shift-bins-min-aln-length", metavar="N", type=int, default=1000),
    _f("--cluster-binsize-combine-mult", metavar="N", type=int, default=5),
    _f("--cluster-resplit-binsize", metavar="N", type=int, default=20),
    _f("--dev-trace-read", metavar="read_id", default=False, type=str),
    _f("--dev-split-max-query-distance-mult", metavar="N", type=int, default=5),
    _f("--dev-no-qc", default=False, action="store_true"),
    _f("--dev-disable-interblock-threads", default=False, action="store_true"),
    _f("--dev-combine-medians", default=False, action="store_true"),
    # extension over the reference: the reference's combine length screen
    # (sv.py:470-471) drops BND groups whose stored svlen is 0 (all
    # inter-contig translocations, whose leads come from Lead.for_bnd) —
    # this flag keeps them in multi-sample output
    _f("--dev-combine-keep-bnd", default=False, action="store_true"),
    _f("--dev-monitor-memory", metavar="N", type=int, default=0),
    _f("--dev-monitor-filename", metavar="memory.csv", type=str),
    _f("--dev-debug-log", default=False, action="store_true"),
    # remote-debug attach (reference: sniffles:70-81): connects to a
    # pydevd/debugpy server listening on localhost:PORT when one of those
    # packages is importable; logs and continues otherwise
    _f("--dev-debug", metavar="PORT", type=int, default=None),
    _f("--dev-progress-log", default=False, action="store_true"),
    _f("--dev-population-snf", metavar="population.snf", type=str),
    _f("--dev-population-min-gt", default=0.75, type=float),
    _f("--dev-filter", default=False, action="store_true"),
    _f("--exclude-flags", "--excl-flags", "-F", default=None, type=int),
    _f("--dev-output-candidates", metavar="OUTPUT.csv", type=str),
    _f("--dev-single-break-count", default=3, type=int),
    _f("--dev-single-break-dist", default=50, type=int),
    _f("--dev-min-leads-cluster", default=-1, type=int),
    _f("--dev-min-dup-vaf", default=1 / 6.0, type=float),
    _f("--dev-longer-del", default=200000, type=int),
    _f("--dev-longer-dup", default=200000, type=int),
    _f("--dev-minreads-extra", default=5, type=int),
    _f("--dev-maxsvlen-extra", default=10000, type=int),
    _f("--dev-locasm-skip-mosaic", default=False, action="store_true"),
    _f("--dev-locasm-do", default=False, action="store_true"),
    _f("--dev-inline-sa-support-max", default=0.80, type=float),
    _f("--dev-min-close-edge-dist", default=500, type=int),
    _f("--dev-min-read-close-edge-prop", default=0.75, type=float),
)

# TPU-specific group (no reference analogue); all shown in expert help.
_TPU_FLAGS = (
    _f("--tpu-batch-size", text="Signature batch size per device for the device clustering/genotyping pipeline", metavar="N", type=int, default=1 << 16),
    _f("--tpu-device-pipeline", text="Run clustering/genotyping statistics on the TPU device pipeline (False: host-only numpy path)", metavar="True", type=tobool, default=True),
    _f("--tpu-mesh-shape", text="Device mesh shape for multi-chip sharding, e.g. '8' for 8-way genome-bin data parallelism, or 'auto'", metavar="dp", type=str, default="auto"),
    _f("--tpu-interpret", text="No effect in this package (its kernels are CUDA; on the CPU each takes its plain PyTorch version); accepted for flag compatibility", default=False, action="store_true"),
    _f("--no-native", text="Disable the native C++ BAM decoder, use the pure-Python decoder (same output)", default=False, action="store_true"),
    _f("--tpu-call", text="Use the device sort-and-segment clustering (the merge sweep kernel) for candidate grouping in call_sample (on by default; --no-tpu gives the host sweep)", default=False, action="store_true"),
    _f("--tpu-combine", text="Use the segmented exact greedy + device edit-distance batching for multi-sample combine (on by default; --no-tpu gives the host greedy)", default=False, action="store_true"),
    _f("--tpu-mesh", text="Shard device work over N devices (a genome mesh with halo exchange): each call task's clustering step, and each combine flush's safe-cut segmentation in multi-sample mode. The shards go to cuda:0 ... cuda:N-1, to the devices SNIFFLES_TPU_MESH_DEVICES names (one a shard, for example cuda:0,cuda:0 for two shards on one card), or to the CPU with SNIFFLES_TPU_FORCE_CPU=1. 0 or 1 = single device", metavar="N", type=int, default=0),
    _f("--no-tpu", text="Never use the device: host cluster sweep (call_sample), host greedy and host edit distance (combine). The device path is on by default, on the CUDA card, or on the CPU with SNIFFLES_TPU_FORCE_CPU=1", default=False, action="store_true"),
)

_FLAG_GROUPS = (
    ("Common parameters", _COMMON_FLAGS),
    ("SV Filtering parameters", _FILTER_FLAGS),
    ("SV Clustering parameters", _CLUSTER_FLAGS),
    ("SV Genotyping parameters", _GENOTYPE_FLAGS),
    ("Multi-Sample Calling / Combine parameters", _COMBINE_FLAGS),
    ("SV Postprocessing, QC and output parameters", _POSTPROCESS_FLAGS),
    ("Mosaic calling mode parameters", _MOSAIC_FLAGS),
    ("Developer parameters", _DEV_FLAGS),
    ("TPU execution parameters", _TPU_FLAGS),
)


class SnifflesConfig(argparse.Namespace):
    """Main configuration object; process-global singleton at SnifflesConfig.GLOBAL."""
    GLOBAL: 'SnifflesConfig'

    header = (f"sniffles-tpu: A TPU-native structural variant (SV) caller for long-read sequencing data\n"
              f" Version {BUILD}")
    usage = ("sniffles-tpu --input SORTED_INPUT.bam [--vcf OUTPUT.vcf] [--snf MERGEABLE_OUTPUT.snf] "
             "[--threads 4] [--mosaic]\n\n" + header +
             "\n\n Use --help for common parameter/usage information and --expert-help for all parameters\n \n")

    # Parameters that exist only as class attributes (no CLI flag), same as
    # the reference (reference: config.py:113,350-384).
    phase: bool = True
    mosaic_min_reads: int = 3
    mosaic_use_strand_thresholds: int = 10
    default_cluster_merge_len: float = 0.22
    default_cluster_merge_len_mosaic: float = 0.27
    dev_output_candidates: str = None

    input: Union[str, list]
    contig: Optional[str]
    input_mode: Literal['rb', 'rc']
    minsupport: Union[str, int]
    combine_population: Union[str, 'PopulationSNF']
    dev_trace_read: bool | str | list

    @property
    def sort(self):
        return self.vcf_output_bgz or not self.no_sort

    @property
    def vcf_output_bgz(self) -> Optional[bool]:
        if not self.vcf:
            return None
        return os.path.splitext(self.vcf)[1] in (".gz", ".bgz")

    @cached_property
    def uncompressed_vcf_name(self) -> str:
        return self.vcf.removesuffix('.gz').removesuffix('.bgz')

    # -- parser construction -----------------------------------------------

    @classmethod
    def build_parser(cls) -> LayeredHelpParser:
        parser = LayeredHelpParser(description="", usage=cls.usage)
        parser.add_argument("--version", action="version", version=f"{VERSION}, Version {BUILD}")
        for title, entries in _FLAG_GROUPS:
            group = parser.add_argument_group(title)
            for names, text, level, extra in entries:
                if text is None:
                    shown = argparse.SUPPRESS
                else:
                    shown = Basic(text) if level else text
                group.add_argument(*names, help=shown, **extra)
        return parser

    def __init__(self, *args, **kwargs):
        super().__init__(**kwargs)
        self.build_parser().parse_args(args=args or None, namespace=self)

        if not (self.tmp_dir and os.path.exists(self.tmp_dir)):
            self.tmp_dir = tempfile.gettempdir()
        if self.quiet:
            sys.stdout = open(os.devnull, "w")

        # provenance stamped into VCF/SNF headers
        self.start_date = datetime.datetime.now().strftime("%Y/%m/%d %H:%M:%S")
        self.run_id = str(os.environ.get("SLURM_JOB_ID") or os.getpid())
        self.command = " ".join(sys.argv)
        self.version, self.build = VERSION, BUILD
        self.snf_format_version = SNF_VERSION
        self.task_count_multiplier = 0

        self._resolve_regions()
        self._derive_screens()
        self._derive_fixed_params()
        self._derive_mosaic()
        self._derive_dev()

        SnifflesConfig.GLOBAL = self

    # -- derivation stages -------------------------------------------------

    def _resolve_regions(self):
        """--regions BED / --region strings -> regions_by_contig
        (reference: config.py:482-505)."""
        if self.contig and self.regions:
            util.fatal_error('Please provide either --contig or --regions, not both.')

        self.regions_by_contig = {}
        if self.regions is not None:
            by_contig = defaultdict(list)
            with open(self.regions, 'r') as handle:
                for line in handle.readlines():
                    if not line.strip() or line.startswith('#'):
                        continue
                    parsed = Region.from_bed_line(line)
                    if parsed is not None:
                        by_contig[parsed.contig].append(parsed)
            self.regions_by_contig = by_contig
        elif self.region:
            for spec in self.region:
                parsed = Region.from_string(spec)
                if parsed is not None:
                    self.regions_by_contig.setdefault(parsed.contig, []).append(parsed)

    def _derive_screens(self):
        """Length/support screens from their string-typed flags
        (reference: config.py:507-543)."""
        # "--minsvlen" governs final output filtering; a tilde prefix makes
        # it soft (well-supported slightly-shorter SVs still pass).
        raw = str(self.minsvlen)
        self.minsvlen_hard_cap = not raw.startswith("~")
        self.minsvlen = int(raw.lstrip("~"))
        self.minsvlen_screen = int(self.minsvlen_screen_ratio * self.minsvlen)

        self.minsupport = (self.minsupport if self.minsupport == "auto"
                           else int(self.minsupport))
        self.no_qc = self.no_qc or self.dev_no_qc

        self.reqc = {"auto": "auto", "0": False, "1": True}.get(self.re_qc)
        if self.reqc is None:
            util.fatal_error('Invalid value for --re-qc, allowed values are: auto, 0, 1')

        # --mapq / --min-alignment-length defaults depend on QC mode
        # (both use default=SUPPRESS, so absence means "not given").
        for attr, qc_default in (("mapq", 20), ("min_alignment_length", 1000)):
            if not hasattr(self, attr):
                setattr(self, attr, 0 if self.dev_no_qc else qc_default)

        self.minsupport_auto_base = 1.5
        self.minsupport_auto_regional_coverage_weight = 0.75
        if self.minsupport_auto_mult is None:
            self.minsupport_auto_mult = 0.1

    # Internal constants the reference hard-derives post-parse
    # (reference: config.py:549-586): INS consensus knobs, long-INS
    # support rescale, genotype column formats, SNF block size, combine
    # internals, and misc output parameters.
    _FIXED_PARAMS = {
        "consensus_min_reads": 4,
        "consensus_kmer_len": 6,
        "consensus_kmer_skip_base": 3,
        "consensus_kmer_skip_seqlen_mult": 1.0 / 500.0,
        "consensus_low_threshold": 0.0,
        "long_ins_rescale_base": 1.66,
        "long_ins_rescale_mult": 0.33,
        "bnd_cluster_length": 1000,
        "genotype_format": "GT:GQ:DR:DV",
        "genotype_none": (".", ".", 0, 0, 0, (None, None)),
        "genotype_null": (0, 0, 0, 0, 0, (None, None)),
        "genotype_min_z_score": 5,
        "snf_block_size": 10 ** 5,
        "combine_exhaustive": False,
        "combine_relabel_rare": False,
        "combine_overlap_abs": 2500,
        "combine_min_size": 100,
        "precise": 25,
        "tandem_repeat_region_pad": 500,
        "id_prefix": "Sniffles2.",
        "dev_profile": False,
    }

    def _derive_fixed_params(self):
        for name, value in self._FIXED_PARAMS.items():
            setattr(self, name, value)
        self.phase_identifiers = ["1", "2"]
        self.workdir = os.getcwd()

        self.coverage_binsize = self.cluster_binsize
        self.coverage_binsize_combine = self.cluster_binsize * self.cluster_binsize_combine_mult

        # Long DEL/DUP coverage screens cap out at 4x the trigger length
        # (reference: config.py:560-561)
        self.dev_longer_dup = min(self.long_dup_length * 4, self.dev_longer_dup)
        self.dev_longer_del = min(self.long_del_length * 4, self.dev_longer_del)

        if self.genotype_ploidy != 2:
            util.fatal_error("Currently only --genotype-ploidy 2 is supported")

    def _derive_mosaic(self):
        """Mosaic-mode overrides (reference: config.py:593-604)."""
        self.mosaic = self.mosaic or self.mosaic_include_germline
        self.qc_nm_measure = self.qc_nm
        if self.mosaic:
            self.qc_nm_measure = self.qc_nm_measure or self.mosaic_qc_nm
            if self.cluster_merge_len == self.default_cluster_merge_len:
                self.cluster_merge_len = self.default_cluster_merge_len_mosaic

    def _derive_dev(self):
        if self.dev_min_leads_cluster == -1:
            self.dev_min_leads_cluster = 1 if self.no_qc else 2

        # The card by default: the device path of both modes is on unless
        # --no-tpu is given, as if --tpu-call and --tpu-combine were set.
        # The device itself is resolved by the entry point (torch_device),
        # which raises when no card is visible and the CPU was not asked for.
        self.device = None
        if self.no_tpu:
            self.tpu_call = False
            self.tpu_combine = False
            self.tpu_mesh = 0
        else:
            self.tpu_call = True
            self.tpu_combine = True

        if self.dev_trace_read or not isinstance(self.dev_trace_read, bool):
            wanted = [name for name in self.dev_trace_read.split(",") if name]
            self.dev_trace_read = wanted if wanted else False


FORCE_CPU_ENV = "SNIFFLES_TPU_FORCE_CPU"


# config.device in a worker process (--threads N): the device belongs to
# the parent's device service, and torch refuses this device string, so a
# device call that reaches a worker without its client raises instead of
# creating a CUDA context in a forked child
WORKER_DEVICE = "none: a worker process reaches the device through the parent's service"


def torch_device() -> str:
    """The device of the port's device path: "cuda", or "cpu" when
    SNIFFLES_TPU_FORCE_CPU asks for it (the tests do; the same switch as
    the JAX package's). With no card and no such request this raises:
    the port never carries on on the CPU by itself. The check asks NVML,
    so it initialises no CUDA runtime and creates no context in a parent
    that forks workers afterwards."""
    if os.environ.get(FORCE_CPU_ENV):
        return "cpu"
    os.environ.setdefault("PYTORCH_NVML_BASED_CUDA_CHECK", "1")
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; set SNIFFLES_TPU_FORCE_CPU=1 to run "
            "the device path on the CPU, or pass --no-tpu for the host path")
    return "cuda"
