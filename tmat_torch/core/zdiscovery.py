"""Z-stack discovery from directories of numbered image files.

Parity target: fl_tissue_model_tools/zstacks.py:18-131 (clean_zstack_ids,
find_zstack_image_sequences, find_zstack_files) and exceptions.py:3-13.
The discovery rules (``z<number>`` slice parsing, reversed multi-number
lexicographic ordering, SequenceMatcher-based ID cleanup) are behavioral
contracts of the reference CLI.

PROVENANCE: re-implemented for this codebase from the reference's observed
behavior, with tests/test_zdiscovery_oracle.py executing the reference's own
functions as the parity oracle. One deliberate, documented divergence exists
in the separator-flattening pass (see clean_zstack_ids).
"""

from __future__ import annotations

import os.path as osp
import re
from difflib import SequenceMatcher
from glob import glob
from typing import Dict, List

FILES_AND_DIRS_ERROR = (
    "Input directory must contain either image files or subdirectories of "
    "image files, but not both."
)

_ZNUM = re.compile(r"z\d+", re.IGNORECASE)
_ZNUM_VALUE = re.compile(r"(?<=z)\d+", re.IGNORECASE)


class ZStackInputError(Exception):
    """Raised when the Z-stack naming/numbering convention can't be parsed."""


def _unless_collision(candidate: List[str], previous: List[str]) -> List[str]:
    """Adopt a simplified id list only when every id stays distinct."""
    return candidate if len(set(candidate)) == len(candidate) else previous


def clean_zstack_ids(zstack_ids: List[str]) -> List[str]:
    """Shorten stack IDs without ever letting two of them collapse into one.

    Behavior of zstacks.py:18-61: four simplification passes — drop a
    directory prefix that only repeats the basename, flatten path separators
    to underscores, strip leading/trailing underscores, collapse doubled
    underscores — each adopted only if all IDs remain distinct.

    DOCUMENTED DIVERGENCE (see PARITY.md "semantic decisions"): the reference
    keeps the separator-flattening pass only when the flattened ids *collide*
    (then it flattens the original ids instead) and discards the flattening
    when it is unique — leaving '/' in ids that downstream become filename
    stems. Here the flattened ids are adopted whenever they stay unique.
    tests/test_zdiscovery_oracle.py executes the reference's own
    clean_zstack_ids and pins both the agreement everywhere else and this
    one intentional difference.
    """
    raw = list(zstack_ids)

    def basename_if_redundant(zid: str) -> str:
        leaf = osp.basename(zid)
        stem = osp.dirname(zid)
        if 2 * len(stem) <= len(leaf):
            return zid
        blocks = SequenceMatcher(a=stem.lower(), b=leaf.lower())
        covered = sum(block.size for block in blocks.get_matching_blocks())
        return leaf if covered == len(stem) else zid

    ids = _unless_collision([basename_if_redundant(z) for z in raw], raw)

    def flatten(zid: str) -> str:
        return zid.replace("/", "_").replace("\\", "_")

    flat = [flatten(z) for z in ids]
    # adopt-if-unique is the divergence documented above; on collision both
    # sides flatten the *original* ids instead
    ids = flat if len(set(flat)) == len(flat) else [flatten(z) for z in raw]

    ids = _unless_collision([z.lstrip("_") for z in ids], ids)
    ids = _unless_collision([z.rstrip("_") for z in ids], ids)
    return _unless_collision([z.replace("__", "_") for z in ids], ids)


def find_zstack_image_sequences(input_dir: str) -> Dict[str, List[str]]:
    """Group numbered per-slice image files into Z stacks.

    Behavior of zstacks.py:64-116: files are taken from the directory itself,
    or (if it holds none) one level down. A slice's stack ID is its relative
    path with the ``z<number>`` token removed from the basename and the
    extension stripped; slices sort by the reversed tuple of all z-numbers in
    the name (so the *last* number varies fastest), ties broken by scan
    order. Mixed numbering widths or duplicate number tuples inside one
    stack are naming-convention errors.
    """
    # sorted: glob returns filesystem enumeration order, which differs
    # even between two processes scanning the same directory — discovery
    # must be deterministic (multi-controller plate runs require every
    # process to build the identical well sequence; reproducible CSV row
    # order falls out for free). Documented parity-plus in PARITY.md.
    paths = sorted(p for p in glob(osp.join(input_dir, "*")) if osp.isfile(p))
    if not paths:
        paths = sorted(
            p for p in glob(osp.join(input_dir, "*", "*")) if osp.isfile(p)
        )

    stack_of = []  # per-slice stack id, parallel to paths
    slice_keys = []  # per-slice reversed z-number list, parallel to paths
    for path in paths:
        rel = osp.relpath(path, input_dir)
        leaf = osp.basename(rel)
        sid = osp.join(osp.dirname(rel), _ZNUM.sub("", leaf))
        stack_of.append(osp.splitext(sid)[0])
        slice_keys.append([int(v) for v in _ZNUM_VALUE.findall(leaf)][::-1])

    # dict.fromkeys, not set(): set iteration order varies with per-process
    # hash randomization, and clean_zstack_ids / the output dict order must
    # be identical in every process of a multi-controller run
    distinct = list(dict.fromkeys(stack_of))
    renamed = dict(zip(distinct, clean_zstack_ids(distinct)))
    stack_of = [renamed[s] for s in stack_of]

    stacks: Dict[str, List[str]] = {}
    for sid in dict.fromkeys(stack_of):
        members = [i for i, s in enumerate(stack_of) if s == sid]
        keys = [slice_keys[i] for i in members]
        if any(len(k) != len(keys[0]) for k in keys):
            raise ZStackInputError("Unrecognized Z slice naming convention")
        if len({tuple(k) for k in keys}) != len(members):
            raise ZStackInputError(
                "Unrecognized Z slice numbering convention in image names"
            )
        order = sorted(key + [i] for i, key in zip(members, keys))
        stacks[sid] = [paths[entry[-1]] for entry in order]

    return stacks


def find_zstack_files(input_dir: str) -> Dict[str, str]:
    """Map stack IDs (filename stems) to single-file Z stacks
    (behavior of zstacks.py:119-131)."""
    paths = sorted(p for p in glob(osp.join(input_dir, "*")) if osp.isfile(p))
    return {osp.splitext(osp.basename(p))[0]: p for p in paths}
