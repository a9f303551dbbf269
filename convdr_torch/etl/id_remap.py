"""TREC run id remap: integer pids -> original corpus document ids.

The counterpart of ``convdr_tpu/etl/id_remap.py``; a port of the
reference's data/id_remap.py:4-18 (used for CAsT-21 whose
composite ``docid-pid`` ids live in ``doc_idx_to_id.pickle``).
"""

from __future__ import annotations

import argparse
import pickle


def remap_run(convdr_trec: str, doc_idx_to_id_path: str, out_trec: str) -> int:
    with open(doc_idx_to_id_path, "rb") as f:
        doc_idx_to_id = pickle.load(f)
    count = 0
    with open(convdr_trec) as f, open(out_trec, "w") as g:
        for line in f:
            qid, _, pid, rank, score, label = line.strip().split()
            g.write(
                f"{qid} Q0 {doc_idx_to_id[int(pid)]} {rank} {score} {label}\n"
            )
            count += 1
    return count


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--convdr_trec", type=str)
    parser.add_argument("--doc_idx_to_id", type=str)
    parser.add_argument("--out_trec", type=str)
    args = parser.parse_args(argv)
    remap_run(args.convdr_trec, args.doc_idx_to_id, args.out_trec)


if __name__ == "__main__":
    main()
