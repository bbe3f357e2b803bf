"""Equality of two SNF files written by two runs.

An SNF is a JSON header line ({config, index, snf_candidate_count})
followed by gzip members, one a block. The gzip bytes carry a time stamp,
so two runs never write the same file. Two SNFs are equal here when their
index and candidate count are equal, each block's decompressed pickle
bytes are equal, and the header's config is equal key by key apart from
keys the caller names: RUN_KEYS_THAT_DIFFER, which differ between any
two runs, and what else differs between the runs it compares."""
import gzip
import json

# config keys of the SNF header that differ between two runs of the same
# input, and why
RUN_KEYS_THAT_DIFFER = {
    "command": "the command line, sys.argv",
    "start_date": "the time the run started",
    "run_id": "the process id of the run",
    "workdir": "the directory the run started in",
    "threads": "--threads, which does not change the output",
    "device": "'cuda' or 'cpu' on the device path, None on --no-tpu",
    "tpu_call": "a device flag, off with --no-tpu",
    "tpu_combine": "a device flag, off with --no-tpu",
    "no_tpu": "the host path's flag",
}


def snf_parts(path):
    """(header config, the rest of the header, {(contig, block): [the
    decompressed pickle bytes of each span]}) of an SNF file."""
    with open(path, "rb") as f:
        header = json.loads(f.readline())
        body = f.read()
    blocks = {(contig, block): [gzip.decompress(body[offset:offset + length])
                                for offset, length in spans]
              for contig, index in header["index"].items()
              for block, spans in index.items()}
    return header.pop("config"), header, blocks


def snf_differences(path, reference, keys_that_differ):
    """(what differs between the SNF at `path` and the one at `reference`,
    apart from the config keys of `keys_that_differ`, as a list of strings,
    empty when they are equal; the config keys that differ, named ones
    included; the reference's blocks)."""
    config, header, blocks = snf_parts(path)
    ref_config, ref_header, ref_blocks = snf_parts(reference)
    found = []
    if header != ref_header:
        found.append("the index or the candidate count")
    if blocks != ref_blocks:
        found.append("the blocks: " + ", ".join(
            f"{contig}:{block}" for contig, block in sorted(set(blocks) | set(ref_blocks))
            if blocks.get((contig, block)) != ref_blocks.get((contig, block))))
    differ = {k for k in set(config) | set(ref_config)
              if config.get(k, "<absent>") != ref_config.get(k, "<absent>")}
    found += [f"config[{k!r}]: {config.get(k, '<absent>')!r} against "
              f"{ref_config.get(k, '<absent>')!r}" for k in sorted(differ - set(keys_that_differ))]
    return found, differ, ref_blocks
