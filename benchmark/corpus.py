"""The data and the query pool of a configuration, made from the seed.

A frozen copy of the repo's clustered Gaussian corpus (`chip_smoke.py:443`
`make_corpus`, itself `bench.py:127`): `centres` blob centres drawn as
`centre_scale` times a standard normal, each row a random centre plus unit
normal noise; a query is a corpus row plus `query_noise` times a standard
normal (`chip_smoke.py:848` `sift_path`). Unlike the original it draws on
the device, with one `torch.Generator` seeded by `--seed`, in blocks of
rows copied to one host array: the port's `Table.insert` takes host rows.
The same seed on the same kind of device gives the same rows.

A configuration with a `documents` block also gets one document a row and
one query text a pool query (`Text`), drawn with a generator of its own,
derived from the seed, after the rows and queries, which it leaves as they
are:

  * a document is a list of words, `w<rank>` for a rank of the block's
    `vocabulary`; its length is `mean_tokens` times a uniform draw from
    [0.5, 1.5), at least 1;
  * each word is, with probability `topical`, a uniform draw from the
    `topic_words` words of its row's blob (the centre the row was drawn
    around; each blob's words a uniform draw from the ranks that are not
    stop words), and otherwise a rank drawn by Zipf's law at exponent
    `zipf_s` over the whole vocabulary: so text and vector agree in part,
    as a paragraph and its embedding do;
  * with `"stop_words": "english"` the vocabulary's highest ranks are the
    English stop words (`ENGLISH_STOPWORDS`, most frequent first), so the
    configuration's `fts` params decide whether they are indexed;
  * a query text is 2 to 6 distinct non-stop words of the document of the
    row its query vector was made from (topped up from the blob's words
    where the document has fewer), joined by spaces.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

BLOCK_ROWS = 131_072
TEXT_STREAM = 0x7465787  # the documents' generators: SeedSequence((seed, TEXT_STREAM))
QUERY_WORDS = (2, 6)  # the fewest and most words of a query text

# The English stop words of the port's analyzer (`text/analyzer.py`),
# restated here, most frequent first: the vocabulary's highest ranks.
ENGLISH_STOPWORDS = (
    "the of and to a in is it that was for on as with by at be this are or not but an they "
    "no there their will if into then these such").split()


@dataclasses.dataclass
class Text:
    """The documents of the rows and the query texts of the pool.

    `vocab[w]` is word w; the words of row i are `ids[offsets[i]:offsets[i
    + 1]]`; `documents` are the same as strings, the words joined by one
    space (what the table stores); `queries[j]` is the query text of pool
    query j."""

    vocab: List[str]
    offsets: np.ndarray  # int64[rows + 1]
    ids: np.ndarray  # int32[words]
    documents: List[str]
    queries: List[str]
    seconds: float  # the time they took to draw


class Corpus(NamedTuple):
    rows: np.ndarray  # f32[rows, dim]
    queries: np.ndarray  # f32[queries, dim]
    text: Optional[Text]  # where the configuration has `documents`


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make(config, seed: int, device) -> Corpus:
    """(rows f32[n, dim], query pool f32[queries, dim], the text or None)
    on the host."""
    spec = config["corpus"]
    n, d, nq = int(config["rows"]), int(config["dim"]), int(config["queries"])
    g = generator(seed, device)
    centres = float(spec["centre_scale"]) * torch.randn(
        int(spec["centres"]), d, generator=g, device=device)
    rows = np.empty((n, d), np.float32)
    blobs = []
    for i in range(0, n, BLOCK_ROWS):
        m = min(BLOCK_ROWS, n - i)
        which = torch.randint(0, centres.shape[0], (m,), generator=g, device=device)
        x = centres[which] + torch.randn(m, d, generator=g, device=device)
        rows[i : i + m] = x.cpu().numpy()
        blobs.append(which)
    pick = torch.randperm(n, generator=g, device=device)[:nq].cpu().numpy()
    noise = torch.randn(nq, d, generator=g, device=device).cpu().numpy()
    queries = rows[pick] + float(spec["query_noise"]) * noise
    text = None
    if "documents" in config:
        text = documents(config, seed, torch.cat(blobs), pick, device)
    return Corpus(rows, queries.astype(np.float32), text)


def vocabulary(spec) -> Tuple[List[str], int]:
    """The words by rank, and how many of the first are stop words: the
    English ones where the block asks, none else."""
    size = int(spec["vocabulary"])
    stops = ENGLISH_STOPWORDS if spec.get("stop_words") == "english" else []
    if size <= len(stops):
        raise ValueError("the vocabulary has no room beside its stop words")
    return list(stops) + [f"w{r}" for r in range(len(stops), size)], len(stops)


def documents(config, seed: int, blob: torch.Tensor, pick: np.ndarray, device) -> Text:
    """The documents of the rows (`blob[i]`: the centre row i was drawn
    around) and the query texts of the pool (`pick[j]`: the row query j was
    made from)."""
    t0 = time.perf_counter()
    spec = config["documents"]
    vocab, n_stop = vocabulary(spec)
    size = len(vocab)
    on_device, on_host = np.random.SeedSequence((int(seed) % (1 << 63), TEXT_STREAM)).spawn(2)
    g = generator(int(on_device.generate_state(1, np.uint64)[0]), device)
    rng = np.random.default_rng(on_host)

    p = torch.arange(1, size + 1, dtype=torch.float64, device=device) ** -float(spec["zipf_s"])
    cdf = torch.cumsum(p, 0)
    cdf = cdf / cdf[-1]
    n_topic = int(spec["topic_words"])
    topics = torch.randint(n_stop, size, (int(config["corpus"]["centres"]), n_topic),
                           generator=g, device=device)
    n = blob.shape[0]
    mean = float(spec["mean_tokens"])
    lengths = (mean * (0.5 + torch.rand(n, generator=g, device=device))).long().clamp_(min=1)
    ids = []
    for i in range(0, n, BLOCK_ROWS):
        ln = lengths[i : i + BLOCK_ROWS]
        owner = torch.repeat_interleave(blob[i : i + BLOCK_ROWS], ln)
        t = owner.shape[0]
        u = torch.rand(t, generator=g, device=device, dtype=torch.float64)
        zipf = torch.searchsorted(cdf, u, right=True).clamp_(max=size - 1)
        topical = topics[owner, torch.randint(0, n_topic, (t,), generator=g, device=device)]
        take = torch.rand(t, generator=g, device=device) < float(spec["topical"])
        ids.append(torch.where(take, topical, zipf).to(torch.int32).cpu())
    words = torch.cat(ids).numpy()
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths.cpu().numpy(), out=offsets[1:])

    tokens = np.asarray(vocab, dtype=object)[words].tolist()
    docs = [" ".join(tokens[a:b]) for a, b in zip(offsets[:-1].tolist(), offsets[1:].tolist())]
    topics = topics.cpu().numpy()
    blob = blob.cpu().numpy()
    queries = []
    for row in pick.tolist():
        own = np.unique(words[offsets[row] : offsets[row + 1]])
        own = own[own >= n_stop]
        want = int(rng.integers(QUERY_WORDS[0], QUERY_WORDS[1] + 1))
        if own.size < want:
            extra = np.setdiff1d(topics[blob[row]], own)
            own = np.concatenate([own, rng.permutation(extra)[: want - own.size]])
        chosen = rng.permutation(own)[:want]
        queries.append(" ".join(vocab[w] for w in chosen.tolist()))
    return Text(vocab, offsets, words, docs, queries, time.perf_counter() - t0)
