"""OR-QuAC ETL: all_blocks.txt + preprocessed splits -> framework inputs.

The counterpart of ``convdr_tpu/etl/orquac.py`` (byte-identical output
files), a behavioral port of the reference's data/preprocess_orquac.py:

  * ``all_blocks.txt`` jsonl -> ``collection.jsonl`` with dense integer ids
    (:17-34, tab/newline scrubbed text, original id -> idx map kept);
  * ``preprocessed/{train,dev,test}.txt`` -> ``{split}.jsonl`` conversational
    records (``input`` = history questions + current question, ``target`` =
    manual rewrite, ``manual_response`` = accumulated answers per dialog,
    reset on dialog change, :50-75) plus ``queries.{split}.manual/raw.tsv``;
  * JSON ``qrels.txt`` -> ``qrels.tsv`` with remapped pids (:78-88).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict


def convert_collection(all_blocks_path: str, out_collection: str) -> Dict[str, int]:
    passage_id_to_idx: Dict[str, int] = {}
    with open(all_blocks_path) as f, open(out_collection, "w") as g:
        for idx, line in enumerate(f):
            obj = json.loads(line)
            text = obj["text"].replace("\n", " ").replace("\t", " ")
            g.write(
                json.dumps({"id": idx, "title": obj["title"], "text": text})
                + "\n"
            )
            passage_id_to_idx[obj["id"]] = idx
    return passage_id_to_idx


def convert_split(split_path: str, out_dir: str, split: str) -> int:
    queries_manual = os.path.join(out_dir, f"queries.{split}.manual.tsv")
    queries_raw = os.path.join(out_dir, f"queries.{split}.raw.tsv")
    out_jsonl = os.path.join(out_dir, f"{split}.jsonl")
    count = 0
    with open(split_path) as f, open(queries_manual, "w") as g, open(
        out_jsonl, "w"
    ) as h, open(queries_raw, "w") as i:
        responses = []
        last_dialog_id = None
        for line in f:
            obj = json.loads(line)
            qid, rewrite = obj["qid"], obj["rewrite"]
            raw_query = obj["question"]
            dialog_id = qid[: qid.rfind("#")]
            if dialog_id != last_dialog_id:
                last_dialog_id = dialog_id
                responses = []
            responses.append(obj["answer"]["text"])
            input_sents = [his["question"] for his in obj["history"]]
            input_sents.append(obj["question"])
            h.write(
                json.dumps(
                    {
                        "qid": qid,
                        "input": input_sents,
                        "target": rewrite,
                        "manual_response": list(responses),
                    }
                )
                + "\n"
            )
            g.write(f"{qid}\t{rewrite}\n")
            i.write(f"{qid}\t{raw_query}\n")
            count += 1
    return count


def convert_qrels(
    qrels_json_path: str, out_path: str, passage_id_to_idx: Dict[str, int]
) -> None:
    with open(qrels_json_path) as f:
        qrels_dict = json.load(f)
    with open(out_path, "w") as out:
        for qid, docs in qrels_dict.items():
            for pid in docs.keys():
                out.write(f"{qid}\t0\t{passage_id_to_idx[pid]}\t1\n")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--orquac_dir", type=str)
    parser.add_argument("--output_dir", type=str)
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    passage_id_to_idx = convert_collection(
        os.path.join(args.orquac_dir, "all_blocks.txt"),
        os.path.join(args.output_dir, "collection.jsonl"),
    )
    for split in ("train", "dev", "test"):
        convert_split(
            os.path.join(args.orquac_dir, "preprocessed", f"{split}.txt"),
            args.output_dir,
            split,
        )
    convert_qrels(
        os.path.join(args.orquac_dir, "qrels.txt"),
        os.path.join(args.output_dir, "qrels.tsv"),
        passage_id_to_idx,
    )


if __name__ == "__main__":
    main()
