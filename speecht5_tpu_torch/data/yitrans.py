"""YiTrans data layer: multilingual BART denoising + language-pair bitext.

A copy of ``speecht5_tpu/data/yitrans.py`` (numpy only; the port may not
import it), so items and collates are bit-equal to JAX's for the same seed
and epoch.  Behavioral spec from reference YiTrans/yitrans_iwslt22/:
- data/denoising_dataset.py:18-90 (DenoisingDatasetLang): BART-noised
  source/target; with a target-language id the BOS is dropped and the
  ``[lang]`` token appended to BOTH source and target, so the collater's
  rotate-last-to-front turns it into the decoder BOS (the mBART convention);
- data/load_langpair_dataset.py:38-170: paired bitext where
  ``append_source_id`` appends ``[src]``/``[tgt]`` after the EOS and the
  generator EOS becomes ``[tgt]``;
- data/lang_pair_mask_dataset.py:25-62 (LangPairMaskDataset): random source
  positions replaced by ``<mask>`` at mask_text_ratio, sparing BOS/EOS;
- tasks/iwslt_translation_from_pretrain.py:135-205: fine-tune loading; when
  NOT append_source_id, prev_output_tokens starts with ``[tgt]`` instead of
  EOS (TransformEosLangPairDataset).

Every random draw is a pure function of (seed, epoch, index), so the
pipeline is deterministic and resumable.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from .dictionary import Dictionary
from .manifests import TOKEN_BUCKETS, bucket_length
from .text_noising import NoisingConfig, noise_tokens


def lang_token(lang: str) -> str:
    """Reference _lang_token, iwslt_joint_pretraining.py:60-63."""
    return f"[{lang}]"


def add_multilingual_symbols(dictionary: Dictionary, langs: Sequence[str]
                             ) -> Dict[str, int]:
    """Add ``[lang]`` tokens for every language plus ``<mask>`` (reference
    iwslt_translation_from_pretrain.py:141-146).  Returns {lang: index}."""
    ids = {l: dictionary.add_symbol(lang_token(l)) for l in langs}
    dictionary.add_symbol("<mask>")
    return ids


def _pad_batch(seqs: List[np.ndarray], pad_id: int, bucketed: bool
               ) -> np.ndarray:
    L = max(len(s) for s in seqs)
    if bucketed:
        L = bucket_length(L, TOKEN_BUCKETS)
    out = np.full((len(seqs), L), pad_id, np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), L)
        out[i, :n] = s[:n]
    return out


def _rotate_prev(tgt: np.ndarray) -> np.ndarray:
    """fairseq move_eos_to_beginning: prev[0] = tgt[-1] (the EOS — or the
    ``[lang]`` tag when one was appended), prev[1:] = tgt[:-1]."""
    return np.concatenate([tgt[-1:], tgt[:-1]])


class MultilingualDenoisingDataset:
    """Mono text of ONE language, BART-noised per epoch (reference
    DenoisingDatasetLang).  ``lines`` are space-separated token strings (the
    fairseq-text format the reference binarizes); items are
    ``bos + tokens + eos`` before noising, then the language tag replaces the
    BOS position (appended at the end) when ``prepend_tgt_lang_tag``."""

    def __init__(
        self,
        lines: Sequence[str],
        dictionary: Dictionary,
        lang: str,
        noising: Optional[NoisingConfig] = None,
        seed: int = 1,
        tokens_per_sample: int = 512,
        prepend_tgt_lang_tag: bool = True,
    ):
        self.dictionary = dictionary
        self.lang = lang
        self.noising = noising or NoisingConfig()
        self.seed = seed
        self.epoch = 0
        self.prepend_tgt_lang_tag = prepend_tgt_lang_tag
        self.mask_id = dictionary.index("<mask>")
        self.lang_id = dictionary.index(lang_token(lang))
        assert self.mask_id != dictionary.unk_index, "add <mask> to the dict first"
        if prepend_tgt_lang_tag:
            assert self.lang_id != dictionary.unk_index, \
                f"add {lang_token(lang)} to the dict first"
        cap = tokens_per_sample - 2
        self.items = [
            np.asarray(dictionary.encode_line(ln, append_eos=False)[:cap],
                       np.int64)
            for ln in lines
        ]
        self.sizes = np.asarray([len(t) + 2 for t in self.items], np.int64)

    def __len__(self):
        return len(self.items)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        d = self.dictionary
        toks = np.concatenate([
            [d.bos_index], self.items[index], [d.eos_index]
        ]).astype(np.int64)
        # noise the interior only (reference asserts source[0]==bos and
        # source[-1]==eos survive, denoising_dataset.py:74-78).
        # NB: not Python hash() — that is salted per process and would break
        # cross-restart determinism/resume.
        seed = int(np.random.SeedSequence(
            [self.seed, self.epoch, index]).generate_state(1)[0])
        src_in, tgt_in = noise_tokens(
            toks[1:-1], self.noising, self.mask_id, len(d), seed
        )
        source = np.concatenate([[d.bos_index], src_in, [d.eos_index]])
        target = np.concatenate([[d.bos_index], tgt_in, [d.eos_index]])
        if self.prepend_tgt_lang_tag:
            # drop bos, append the language tag (reference :81-84)
            source = np.concatenate([source[1:], [self.lang_id]])
            target = np.concatenate([target[1:], [self.lang_id]])
        return {"source": source, "target": target}

    def collate(self, items: List[Dict], bucketed: bool = True) -> Dict:
        pad = self.dictionary.pad_index
        src = _pad_batch([it["source"] for it in items], pad, bucketed)
        tgt = _pad_batch([it["target"] for it in items], pad, bucketed)
        prev = _pad_batch(
            [_rotate_prev(it["target"]) for it in items], pad, bucketed
        )
        return {
            "src_tokens": src,
            "src_lengths": np.asarray([len(it["source"]) for it in items],
                                      np.int32),
            "prev_tokens": prev,
            "targets": tgt,
            "target_lengths": np.asarray([len(it["target"]) for it in items],
                                         np.int32),
        }


class LangPairDataset:
    """Paired bitext with language-id handling + optional source masking.

    ``append_source_id`` (pretrain MT path, reference
    load_langpair_dataset.py:137-146): ``[src]`` / ``[tgt]`` appended after
    each side's EOS; the collater's rotation then puts ``[tgt]`` first in
    prev_output_tokens.  Otherwise (fine-tune path, reference
    iwslt_translation_from_pretrain.py:198-205) prev_output_tokens starts
    with ``[tgt]`` replacing the EOS BOS.
    """

    def __init__(
        self,
        src_lines: Sequence[str],
        tgt_lines: Sequence[str],
        src_dict: Dictionary,
        tgt_dict: Dictionary,
        src_lang: str,
        tgt_lang: str,
        append_source_id: bool = False,
        mask_text_ratio: float = 0.0,
        seed: int = 1,
        max_positions: int = 1024,
    ):
        assert len(src_lines) == len(tgt_lines)
        self.src_dict, self.tgt_dict = src_dict, tgt_dict
        self.src_lang, self.tgt_lang = src_lang, tgt_lang
        self.append_source_id = append_source_id
        self.mask_text_ratio = mask_text_ratio
        self.seed = seed
        self.epoch = 0
        self.mask_id = src_dict.index("<mask>")
        self.src_lang_id = src_dict.index(lang_token(src_lang))
        self.tgt_lang_id = tgt_dict.index(lang_token(tgt_lang))
        assert self.tgt_lang_id != tgt_dict.unk_index, \
            f"add {lang_token(tgt_lang)} to the dict first"
        cap = max_positions - 2
        self.src_items = [
            np.asarray(src_dict.encode_line(ln, append_eos=True)[: cap + 1],
                       np.int64) for ln in src_lines
        ]
        self.tgt_items = [
            np.asarray(tgt_dict.encode_line(ln, append_eos=True)[: cap + 1],
                       np.int64) for ln in tgt_lines
        ]
        self.src_sizes = np.asarray(
            [len(t) + int(append_source_id) for t in self.src_items], np.int64
        )
        self.tgt_sizes = np.asarray(
            [len(t) + int(append_source_id) for t in self.tgt_items], np.int64
        )
        self.sizes = np.maximum(self.src_sizes, self.tgt_sizes)

    def __len__(self):
        return len(self.src_items)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _mask_source(self, src: np.ndarray, index: int) -> np.ndarray:
        """LangPairMaskDataset.mask_src_tokens (reference
        lang_pair_mask_dataset.py:43-57): random positions -> <mask>; BOS,
        EOS and the appended language tag are spared."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index, 0xA5])
        )
        keep = rng.random(len(src)) > self.mask_text_ratio
        protected = (src == self.src_dict.eos_index)
        if self.append_source_id:
            protected |= (src == self.src_lang_id)
        protected |= np.arange(len(src)) == 0
        out = np.where(keep | protected, src, self.mask_id)
        return out

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        src = self.src_items[index]
        tgt = self.tgt_items[index]
        if self.append_source_id:
            src = np.concatenate([src, [self.src_lang_id]])
            tgt = np.concatenate([tgt, [self.tgt_lang_id]])
        if self.mask_text_ratio > 0:
            src = self._mask_source(src, index)
        return {"source": src, "target": tgt}

    def collate(self, items: List[Dict], bucketed: bool = True) -> Dict:
        pad = self.tgt_dict.pad_index
        src = _pad_batch([it["source"] for it in items],
                         self.src_dict.pad_index, bucketed)
        tgt = _pad_batch([it["target"] for it in items], pad, bucketed)
        prevs = []
        for it in items:
            prev = _rotate_prev(it["target"])
            if not self.append_source_id:
                # TransformEosLangPairDataset: decoder BOS is [tgt_lang]
                # instead of the rotated EOS (reference
                # iwslt_translation_from_pretrain.py:198-205)
                prev[0] = self.tgt_lang_id
            prevs.append(prev)
        prev = _pad_batch(prevs, pad, bucketed)
        return {
            "src_tokens": src,
            "src_lengths": np.asarray([len(it["source"]) for it in items],
                                      np.int32),
            "prev_tokens": prev,
            "targets": tgt,
            "target_lengths": np.asarray([len(it["target"]) for it in items],
                                         np.int32),
        }
