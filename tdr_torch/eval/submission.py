# Copied from tdr/eval/submission.py unchanged.
"""Submission writer + validator.

Output contract: ``submission.csv`` with columns ``id, docids`` where docids
is a 10-element python-list literal per query (bm25_ranking.ipynb:399-407,
final_implementation.py:527-530, submission.csv:1).  The validator re-checks
what debug.py:1-15 checks (duplicate ids) plus row-shape errors.
"""

from __future__ import annotations

import ast
import csv
from typing import List, Sequence


def write_submission(
    retrieved: Sequence[Sequence[str]], path: str, ids: Sequence[str] = None,
    k: int = 10, wide: bool = False,
) -> None:
    """``wide=False``: id + python-list docids column (the winning format);
    ``wide=True``: one doc_1..doc_k column per rank (the ANN pipeline's
    variant, faiss_based_ANN_Implementation.py:292-295)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        if wide:
            w.writerow(["id"] + [f"doc_{j + 1}" for j in range(k)])
            for i, docs in enumerate(retrieved):
                qid = ids[i] if ids is not None else i
                row = list(docs[:k]) + [""] * (k - len(docs[:k]))
                w.writerow([qid] + row)
            return
        w.writerow(["id", "docids"])
        for i, docs in enumerate(retrieved):
            qid = ids[i] if ids is not None else i
            w.writerow([qid, str(list(docs[:k]))])


def _is_wide_header(hs: List[str]) -> bool:
    """The ``id, doc_1..doc_k`` header (one column per rank) — shared by
    the reader and the validator so they can never disagree about which
    files are 'wide'."""
    return (len(hs) > 1 and hs[0] == "id"
            and all(h == f"doc_{j + 1}" for j, h in enumerate(hs[1:])))


def read_submission(path: str):
    """(ids, rankings) from either :func:`write_submission` format —
    the inverse used by ``tdr fuse`` to ensemble finished runs."""
    ids: List[str] = []
    rankings: List[List[str]] = []
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader, None)
        hs = [h.strip() for h in header] if header else []
        wide = _is_wide_header(hs)
        if not wide and hs[:2] != ["id", "docids"]:
            raise ValueError(f"unrecognized submission header: {header}")
        for row in reader:
            if not row:
                continue
            ids.append(row[0])
            if wide:
                rankings.append([d for d in row[1:] if d != ""])
            else:
                docs = ast.literal_eval(row[1])
                if not isinstance(docs, list):
                    raise ValueError(f"row {row[0]}: docids is not a list")
                rankings.append([str(d) for d in docs])
    return ids, rankings


def validate_submission(path: str, expect_k: int = 10) -> List[str]:
    """Returns a list of problems (empty = valid).

    Understands both output formats of :func:`write_submission`: the
    list-literal ``id,docids`` format and the wide ``id,doc_1..doc_k``
    format."""
    problems: List[str] = []
    seen = set()
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader, None)
        hs = [h.strip() for h in header] if header else []
        if _is_wide_header(hs):
            # wide format
            if len(hs) - 1 != expect_k:
                problems.append(
                    f"bad header: expected {expect_k} doc_* columns, got {len(hs) - 1}")
            for row_num, row in enumerate(reader, start=2):
                if len(row) != len(hs):
                    problems.append(f"row {row_num}: expected {len(hs)} columns, got {len(row)}")
                    continue
                qid, docids = row[0], [d for d in row[1:] if d != ""]
                if qid in seen:
                    problems.append(f"row {row_num}: duplicate id {qid!r}")
                seen.add(qid)
                if len(docids) != expect_k:
                    problems.append(f"row {row_num}: expected {expect_k} docids, got {len(docids)}")
                elif len(set(docids)) != len(docids):
                    problems.append(f"row {row_num}: duplicate docids within query")
            return problems
        if header is None or hs[:2] != ["id", "docids"]:
            problems.append(f"bad header: {header}")
        for row_num, row in enumerate(reader, start=2):
            if len(row) < 2:
                problems.append(f"row {row_num}: missing columns")
                continue
            qid, docids_s = row[0], row[1]
            if qid in seen:
                problems.append(f"row {row_num}: duplicate id {qid!r}")
            seen.add(qid)
            try:
                docids = ast.literal_eval(docids_s)
            except (ValueError, SyntaxError):
                problems.append(f"row {row_num}: unparseable docids")
                continue
            if not isinstance(docids, list) or len(docids) != expect_k:
                problems.append(f"row {row_num}: expected {expect_k} docids, got {len(docids) if isinstance(docids, list) else type(docids)}")
            elif len(set(docids)) != len(docids):
                problems.append(f"row {row_num}: duplicate docids within query")
    return problems
