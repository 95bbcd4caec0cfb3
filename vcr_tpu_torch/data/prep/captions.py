"""Offline caption preparation for the three corpora, the counterpart of
``vcr_tpu/data/prep/captions.py``.

Produces the ``{split}_captions.json`` artifacts consumed by the runtime
pipeline. Semantics match the reference prep scripts:

* MSVD  — multilingual_corpus.csv -> English rows -> join with present
  clips/*.avi -> group by VideoID_Start_End -> shuffled 85/15 train/val
  (reference: data/msvd/extract_captions.py:8-46)
* MSR-VTT — videodatainfo_2017_ustc.json -> join with clips/*.mp4 ->
  shuffled 80/20 video-level split -> sentences grouped per video
  (reference: data/msrvtt/extract_captions.py:8-39)
* MSVD-VGG — sents_{train,val,test}_lc_nopunc.txt (tab-separated, pre-split)
  -> per-split captions JSON (reference: data/msvd_vgg/extract_captions.py:8-38)
"""

from __future__ import annotations

import csv
import json
import os
import random


def extract_captions_msvd(data_dir: str, corpus: str = "msvd",
                          train_perc: float = 0.85, seed=None) -> None:
    corpus_dir = os.path.join(data_dir, corpus)
    caption_file = os.path.join(corpus_dir, "multilingual_corpus.csv")
    clips_dir = os.path.join(corpus_dir, "clips/")
    clips = {f for f in os.listdir(clips_dir) if f.endswith(".avi")}

    with open(caption_file) as fp:
        captions = [row for row in csv.DictReader(fp) if row["Language"] == "English"]

    valid = [c for c in captions
             if f"{c['VideoID']}_{c['Start']}_{c['End']}.avi" in clips]
    print(f"Found {len(captions)} captions in {caption_file}")
    print(f"Dropping {len(captions) - len(valid)} captions because of missing video files")

    by_key = {}
    for c in valid:
        key = f"{c['VideoID']}_{c['Start']}_{c['End']}"
        if key not in by_key:
            by_key[key] = {
                "video_key": key, "video_id": c["VideoID"], "start": c["Start"],
                "end": c["End"], "lang": c["Language"], "captions": [],
                "file_path": os.path.join("clips/", key + ".avi"),
            }
        by_key[key]["captions"].append({"desc": c["Description"],
                                        "source": c["Source"]})

    videos = list(by_key.values())
    random.Random(seed).shuffle(videos)
    split_at = int(len(videos) * train_perc)
    for split, chunk in (("train", videos[:split_at]), ("val", videos[split_at:])):
        with open(os.path.join(corpus_dir, f"{split}_captions.json"), "w") as fp:
            json.dump(chunk, fp)


def extract_captions_msrvtt(data_dir: str, corpus: str = "msrvtt",
                            train_perc: float = 0.80, seed=None) -> None:
    corpus_dir = os.path.join(data_dir, corpus)
    caption_file = os.path.join(corpus_dir, "videodatainfo_2017_ustc.json")
    clips_dir = os.path.join(corpus_dir, "clips/")
    clips = {f for f in os.listdir(clips_dir) if f.endswith(".mp4")}

    with open(caption_file) as fp:
        content = json.load(fp)

    videos = [v for v in content["videos"] if v["video_id"] + ".mp4" in clips]
    random.Random(seed).shuffle(videos)
    print(f"Found {len(content['videos'])} videos in {caption_file}")
    print(f"Dropping {len(content['videos']) - len(videos)} videos because of "
          "missing video files")
    split_at = int(len(videos) * train_perc)
    train_ids = {v["video_id"] for v in videos[:split_at]}
    present_ids = {v["video_id"] for v in videos}

    by_id = {}
    for sent in content["sentences"]:
        vid = sent["video_id"]
        if vid not in present_ids:
            continue
        if vid not in by_id:
            by_id[vid] = {"video_id": vid,
                          "split": "train" if vid in train_ids else "val",
                          "captions": []}
        by_id[vid]["captions"].append({"desc": sent["caption"],
                                       "sen_id": sent["sen_id"]})

    all_videos = list(by_id.values())
    for split in ("train", "val"):
        with open(os.path.join(corpus_dir, f"{split}_captions.json"), "w") as fp:
            json.dump([v for v in all_videos if v["split"] == split], fp)


def extract_captions_msvd_vgg(data_dir: str, corpus: str = "msvd_vgg") -> None:
    corpus_dir = os.path.join(data_dir, corpus)
    for split in ("train", "val", "test"):
        caption_file = os.path.join(corpus_dir, f"sents_{split}_lc_nopunc.txt")
        by_key = {}
        with open(caption_file) as fp:
            for line in fp:
                parts = line.strip().split("\t")
                key, caption = parts[0], " ".join(parts[1:])
                if key not in by_key:
                    by_key[key] = {"video_key": key, "captions": []}
                by_key[key]["captions"].append({"desc": caption})
        with open(os.path.join(corpus_dir, f"{split}_captions.json"), "w") as fp:
            json.dump(list(by_key.values()), fp)


def extract_captions(cfg) -> None:
    """Dispatch on ``cfg.corpus`` to its extractor."""
    if cfg.corpus == "msvd":
        extract_captions_msvd(cfg.data_dir, cfg.corpus, seed=cfg.seed)
    elif cfg.corpus == "msrvtt":
        extract_captions_msrvtt(cfg.data_dir, cfg.corpus, seed=cfg.seed)
    elif cfg.corpus == "msvd_vgg":
        extract_captions_msvd_vgg(cfg.data_dir, cfg.corpus)
    else:
        raise NotImplementedError("unknown corpus")
