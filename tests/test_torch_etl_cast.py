"""The port's dataset ETL (CAsT-19/20/21, OR-QuAC, the TREC id remap and
the CAR + MARCO merge) against the JAX package's on raw inputs made from a
seed: both write the same bytes, file for file (collections, topics and
their fold files, query tsvs, qrels, the pickled id maps), and return the
same values."""

import filecmp
import json
import os
import pickle

import numpy as np
import pytest

from convdr_torch.etl import cast19 as t19
from convdr_torch.etl import cast20 as t20
from convdr_torch.etl import cast21 as t21
from convdr_torch.etl import common as tcommon
from convdr_torch.etl import id_remap as tremap
from convdr_torch.etl import orquac as torquac
from convdr_torch.etl.cbor_car import encode_item
from convdr_tpu.etl import cast19 as j19
from convdr_tpu.etl import cast20 as j20
from convdr_tpu.etl import cast21 as j21
from convdr_tpu.etl import common as jcommon
from convdr_tpu.etl import id_remap as jremap
from convdr_tpu.etl import orquac as jorquac

WORDS = ("cat", "dog", "fish", "bird", "river", "stone", "über", "naïve", "東京", "tea")


def text(rng, lo=2, hi=9, ws=False):
    """Seeded words; with ``ws`` some tabs, newlines and carriage returns
    that the ETL must scrub."""
    words = list(rng.choice(WORDS, int(rng.integers(lo, hi))))
    if ws:
        for _ in range(int(rng.integers(0, 3))):
            words.insert(int(rng.integers(0, len(words) + 1)), str(rng.choice(["\t", "\n", "\r"])))
    return " ".join(words)


def write_car_marco(work, rng, n_car, n_marco):
    """A CAR CBOR dump (a v2 header item, ParaText and ParaLink bodies, some
    byte-string ids, one non-paragraph item), a MARCO tsv and a duplicate
    list naming a seeded quarter of the MARCO ids (and one empty line)."""
    car = os.path.join(work, "car.cbor")
    with open(car, "wb") as f:
        f.write(encode_item([0, "header", [1, 5]]))
        for i in range(n_car):
            bodies = []
            for _ in range(int(rng.integers(1, 4))):
                if rng.random() < 0.3:
                    bodies.append([1, "Page", f"page-{i}", text(rng, 1, 3)])
                else:
                    bodies.append([0, text(rng, ws=True)])
            pid = f"car{i:05d}" + "x" * int(rng.integers(0, 3))
            f.write(encode_item([1, pid.encode() if i % 5 == 0 else pid, bodies]))
            if i == n_car // 2:
                f.write(encode_item("not a paragraph"))
    marco = os.path.join(work, "marco.tsv")
    with open(marco, "w") as f:
        for i in range(n_marco):
            f.write(f"{i}\t{text(rng)}\n")
    dups = sorted(rng.choice(n_marco, max(1, n_marco // 4), replace=False).tolist())
    dup = os.path.join(work, "dup.txt")
    with open(dup, "w") as f:
        for j, d in enumerate(dups):
            f.write(f"CAR_car{j:05d}:MARCO_{d}" + (f",MARCO_{dups[0]}" if j % 3 == 2 else "") + "\n")
        f.write("CAR_car00001:\n")
    return car, marco, dup


def car_ids(car):
    from convdr_torch.etl.cbor_car import iter_paragraphs

    with open(car, "rb") as f:
        return ["CAR_" + p.para_id for p in iter_paragraphs(f)]


def write_cast19(work, rng, n_topics):
    car, marco, dup = write_car_marco(work, rng, 40, 60)
    cast = os.path.join(work, "cast")
    os.makedirs(cast)
    topics = []
    with open(os.path.join(cast, "evaluation_topics_annotated_resolved_v1.0.tsv"), "w") as f:
        for t in range(n_topics):
            turns = []
            for n in range(1, int(rng.integers(1, 5)) + 1):
                turns.append({"number": n, "raw_utterance": text(rng)})
                f.write(f"{31 + t}_{n}\t{text(rng)}\n")
            topics.append({"number": 31 + t, "title": text(rng, 1, 3),
                           "description": text(rng) if t % 2 else "", "turn": turns})
    with open(os.path.join(cast, "evaluation_topics_v1.0.json"), "w") as f:
        json.dump(topics, f)
    ids = car_ids(car)
    with open(os.path.join(cast, "2019qrels.txt"), "w") as f:
        for t in topics:
            for turn in t["turn"]:
                qid = f"{t['number']}_{turn['number']}"
                for _ in range(3):
                    f.write(f"{qid} 0 {rng.choice(ids)} {int(rng.integers(0, 3))}\n")
                f.write(f"{qid} Q0 MARCO_{int(rng.integers(0, 60))} 1\n")
                if rng.random() < 0.3:
                    f.write(f"{qid} 0 WAPO_{int(rng.integers(0, 9))} 1\n")  # dropped
    return car, marco, dup, cast


def write_cast20(work, rng, cast, car, marco, dup):
    ids = car_ids(car)
    with open(dup) as f:
        dropped = set(tcommon.parse_sim_file(dup))
    marco_ids = [f"MARCO_{i}" for i in range(60) if f"MARCO_{i}" not in dropped]
    auto, manual = [], []
    for t in range(6):
        a_turns, m_turns = [], []
        for n in range(1, int(rng.integers(1, 5)) + 1):
            pool = ids if rng.random() < 0.5 else marco_ids
            a_turns.append({"number": n, "raw_utterance": text(rng),
                            "automatic_canonical_result_id": str(rng.choice(pool))})
            pool = ids if rng.random() < 0.5 else marco_ids
            m_turns.append({"number": n, "manual_rewritten_utterance": text(rng),
                            "manual_canonical_result_id": str(rng.choice(pool))})
        auto.append({"number": 81 + 2 * t, "turn": a_turns})
        manual.append({"number": 81 + 2 * t, "turn": m_turns})
    with open(os.path.join(cast, "2020_automatic_evaluation_topics_v1.0.json"), "w") as f:
        json.dump(auto, f)
    with open(os.path.join(cast, "2020_manual_evaluation_topics_v1.0.json"), "w") as f:
        json.dump(manual, f)
    with open(os.path.join(cast, "2020qrels.txt"), "w") as f:
        for t in auto:
            f.write(f"{t['number']}_1 0 {rng.choice(ids)} 2\n")
            f.write(f"{t['number']}_1 0 {rng.choice(marco_ids)} 1\n")


def cast19_argv(work, car, marco, dup, cast, tag):
    return ["--car_cbor", car, "--msmarco_collection", marco, "--duplicate_file", dup,
            "--cast_dir", cast, "--out_data_dir", os.path.join(work, f"{tag}_data"),
            "--out_collection_dir", os.path.join(work, f"{tag}_coll")]


def assert_same_tree(a, b, at_least):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert len(names) >= at_least, names
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_topics", [5, 7])
def test_cast19_byte_identical_to_jax(tmp_path, seed, n_topics):
    """7 topics: 5 does not divide them, so the tail topics land on no fold
    file, in both packages."""
    work = str(tmp_path)
    car, marco, dup, cast = write_cast19(work, np.random.default_rng(seed), n_topics)
    t19.main(cast19_argv(work, car, marco, dup, cast, "torch"))
    j19.main(cast19_argv(work, car, marco, dup, cast, "jax"))
    assert_same_tree(os.path.join(work, "torch_data"), os.path.join(work, "jax_data"), 9)
    assert_same_tree(os.path.join(work, "torch_coll"), os.path.join(work, "jax_coll"), 3)
    with open(os.path.join(work, "torch_coll", "car_id_to_idx.pickle"), "rb") as f:
        assert min(pickle.load(f).values()) == tcommon.CAR_BASE_ID


@pytest.mark.parametrize("seed", [3, 4])
def test_cast20_byte_identical_to_jax(tmp_path, seed):
    work = str(tmp_path)
    rng = np.random.default_rng(seed)
    car, marco, dup, cast = write_cast19(work, rng, 5)
    write_cast20(work, rng, cast, car, marco, dup)
    for tag, mod in (("torch", t20), ("jax", j20)):
        mod.main(cast19_argv(work, car, marco, dup, cast, tag))
    assert_same_tree(os.path.join(work, "torch_data"), os.path.join(work, "jax_data"), 9)
    assert_same_tree(os.path.join(work, "torch_coll"), os.path.join(work, "jax_coll"), 3)
    assert t20.cast20_fold(96) == j20.cast20_fold(96) == 3


@pytest.mark.parametrize("raw_id", ["MARCO_0", "CAR_car00003", "WAPO_1", "MARCO_999"])
def test_cast20_resolve_raw_id_same_answer_or_error(raw_id):
    maps = ({"CAR_car00003": 10_000_003}, {0: "zero", 10_000_003: "car three"})
    outcomes = []
    for mod in (t20, j20):
        try:
            outcomes.append(mod.resolve_raw_id(raw_id, *maps))
        except ValueError as e:
            outcomes.append(("ValueError", str(e)))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("keep_in_memory", [False, True])
def test_merge_car_marco_collection_and_its_reload_match_jax(tmp_path, keep_in_memory):
    """A fresh merge and the reload of existing outputs: the same files and
    the same returned maps in both packages."""
    work = str(tmp_path)
    car, marco, dup = write_car_marco(work, np.random.default_rng(5), 30, 40)
    got = {}
    for tag, mod in (("torch", tcommon), ("jax", jcommon)):
        out = [os.path.join(work, f"{tag}_{n}") for n in
               ("collection.tsv", "car_id_to_idx.pickle", "car_idx_to_id.pickle")]
        first = mod.merge_car_marco_collection(car, marco, dup, *out,
                                               keep_in_memory=keep_in_memory)
        again = mod.merge_car_marco_collection(car, marco, dup, *out,
                                               keep_in_memory=keep_in_memory)
        got[tag] = (first, again, [open(p, "rb").read() for p in out])
    assert got["torch"] == got["jax"]
    (ids, coll), (ids2, coll2), _files = got["torch"]
    assert ids == ids2 and len(ids) == 30
    if keep_in_memory:
        # the reload strips each line, as the JAX package's does: the same
        # pids, texts equal up to their trailing whitespace
        assert set(coll) == set(coll2) and len(coll) > 30
        assert {k: v.rstrip() for k, v in coll.items()} == coll2
    else:
        assert coll is None and coll2 is None


def write_cast21(work, rng):
    """Three corpus files (KILT, MARCO docs, WaPo), documents with several
    passages, an empty title, a pid with leading zeros, a passage body over
    several lines; topics whose canonical results point into each file."""
    paths, refs = [], []
    for c, name in enumerate(("kilt", "msmarco", "wapo")):
        docs = []
        for d in range(int(rng.integers(2, 5))):
            docno = f"{name.upper()}_{d}"
            title = "" if (c + d) % 4 == 1 else text(rng, 1, 4)
            passages = []
            for k in range(int(rng.integers(1, 4))):
                pid = f"{k:03d}" if d == 0 else str(k)
                passages.append(f"<passage id={pid}>\n{text(rng, ws=True)}\n</passage>")
                refs.append((docno, k))
            docs.append(f"<DOC>\n<DOCNO>{docno}</DOCNO>\n<TITLE>{title}</TITLE>\n"
                        + "\n".join(passages) + "\n</DOC>\n")
        path = os.path.join(work, f"{name}.txt")
        with open(path, "w") as f:
            f.write("".join(docs))
        paths.append(path)
    cast = os.path.join(work, "cast21")
    os.makedirs(cast)
    topics = []
    for t in range(6):
        turns = []
        for n in range(1, int(rng.integers(1, 4)) + 1):
            docno, k = refs[int(rng.integers(0, len(refs)))]
            turns.append({"number": n, "raw_utterance": text(rng),
                          "manual_rewritten_utterance": text(rng),
                          "canonical_result_id": docno, "passage_id": k})
        topics.append({"number": 106 + t, "turn": turns})
    with open(os.path.join(cast, "2021_manual_evaluation_topics_v1.0.json"), "w") as f:
        json.dump(topics, f)
    return paths, cast


@pytest.mark.parametrize("seed", [6, 7])
@pytest.mark.parametrize("drop", [None, 1])
def test_cast21_byte_identical_to_jax(tmp_path, seed, drop):
    """All three corpus files, or the MARCO docs given as an empty path
    (skipped by both)."""
    work = str(tmp_path)
    paths, cast = write_cast21(work, np.random.default_rng(seed))
    if drop is not None:
        paths[drop] = ""
        # no topic may point into a skipped file
        with open(os.path.join(cast, "2021_manual_evaluation_topics_v1.0.json")) as f:
            topics = json.load(f)
        for t in topics:
            t["turn"] = [u for u in t["turn"] if not u["canonical_result_id"].startswith("MSMARCO")]
        with open(os.path.join(cast, "2021_manual_evaluation_topics_v1.0.json"), "w") as f:
            json.dump([t for t in topics if t["turn"]], f)
    for tag, mod in (("torch", t21), ("jax", j21)):
        mod.main(["--kilt", paths[0], "--msmarco", paths[1], "--wapo", paths[2],
                  "--cast_dir", cast, "--out_data_dir", os.path.join(work, f"{tag}_data"),
                  "--out_collection_dir", os.path.join(work, f"{tag}_coll")])
    assert_same_tree(os.path.join(work, "torch_data"), os.path.join(work, "jax_data"), 9)
    assert_same_tree(os.path.join(work, "torch_coll"), os.path.join(work, "jax_coll"), 3)
    with open(os.path.join(work, "torch_coll", "doc_idx_to_id.pickle"), "rb") as f:
        idx_to_id = pickle.load(f)
    assert "KILT_0-0" in idx_to_id  # pid "000" canonicalized
    # the reload path returns the same maps in both packages
    reloaded = [mod.build_collection(paths, *[os.path.join(work, f"{tag}_coll", n) for n in
                                             ("collection.tsv", "doc_id_to_idx.pickle",
                                              "doc_idx_to_id.pickle")])
                for tag, mod in (("torch", t21), ("jax", j21))]
    assert reloaded[0] == reloaded[1]


def test_cast21_parser_matches_jax_on_unclosed_tags(tmp_path, caplog):
    content = ("<DOC><DOCNO>D</DOCNO><TITLE></TITLE><passage id=0>fine</passage>"
               "<passage id=1>never closed")
    outs = []
    for tag, mod in (("torch", t21), ("jax", j21)):
        maps = ({}, [], {})
        with open(tmp_path / f"{tag}.tsv", "w") as out:
            n = mod.parse_documents(content, *maps, out, pidx=5)
        outs.append((n, maps, (tmp_path / f"{tag}.tsv").read_bytes()))
    assert outs[0] == outs[1]
    assert outs[0][0] == 6 and outs[0][1][2] == {5: " fine"}
    assert sum("unclosed" in r.message for r in caplog.records) == 2


def write_orquac(work, rng):
    orq = os.path.join(work, "orquac")
    os.makedirs(os.path.join(orq, "preprocessed"))
    blocks = [f"B{i}" for i in range(12)]
    with open(os.path.join(orq, "all_blocks.txt"), "w") as f:
        for b in blocks:
            f.write(json.dumps({"id": b, "title": text(rng, 1, 3), "text": text(rng, ws=True)})
                    + "\n")
    qids = []
    for split in ("train", "dev", "test"):
        with open(os.path.join(orq, "preprocessed", f"{split}.txt"), "w") as f:
            for d in range(3):
                history = []
                for turn in range(int(rng.integers(1, 4))):
                    qid = f"{split}_D{d}#{turn}"
                    q = text(rng)
                    f.write(json.dumps({"qid": qid, "question": q, "rewrite": text(rng),
                                        "answer": {"text": text(rng)},
                                        "history": list(history)}) + "\n")
                    history.append({"question": q})
                    qids.append(qid)
    with open(os.path.join(orq, "qrels.txt"), "w") as f:
        json.dump({q: {str(rng.choice(blocks)): 1} for q in qids}, f)
    return orq


@pytest.mark.parametrize("seed", [8, 9])
def test_orquac_byte_identical_to_jax(tmp_path, seed):
    orq = write_orquac(str(tmp_path), np.random.default_rng(seed))
    for tag, mod in (("torch", torquac), ("jax", jorquac)):
        mod.main(["--orquac_dir", orq, "--output_dir", str(tmp_path / tag)])
    assert_same_tree(str(tmp_path / "torch"), str(tmp_path / "jax"), 11)
    train = [json.loads(ln) for ln in open(tmp_path / "torch" / "train.jsonl")]
    # the accumulated answers reset with each new dialog
    firsts = [r for r in train if r["qid"].endswith("#0")]
    assert firsts and all(len(r["manual_response"]) == 1 for r in firsts)


@pytest.mark.parametrize("seed", [10, 11])
def test_id_remap_byte_identical_to_jax(tmp_path, seed):
    rng = np.random.default_rng(seed)
    idx_to_id = [f"DOC_{int(rng.integers(0, 99))}-{k}" for k in range(50)]
    with open(tmp_path / "map.pickle", "wb") as f:
        pickle.dump(idx_to_id, f)
    with open(tmp_path / "in.trec", "w") as f:
        for q in range(4):
            for rank, pid in enumerate(rng.choice(50, 10, replace=False)):
                f.write(f"106_{q} Q0 {pid} {rank + 1} {200 - rank} ance\n")
    counts = []
    for tag, mod in (("torch", tremap), ("jax", jremap)):
        counts.append(mod.remap_run(str(tmp_path / "in.trec"), str(tmp_path / "map.pickle"),
                                    str(tmp_path / f"{tag}.trec")))
    tremap.main(["--convdr_trec", str(tmp_path / "in.trec"), "--doc_idx_to_id",
                 str(tmp_path / "map.pickle"), "--out_trec", str(tmp_path / "cli.trec")])
    assert counts == [40, 40]
    assert (tmp_path / "torch.trec").read_bytes() == (tmp_path / "jax.trec").read_bytes()
    assert (tmp_path / "cli.trec").read_bytes() == (tmp_path / "jax.trec").read_bytes()
