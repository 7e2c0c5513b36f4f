"""fairseq-format symbol dictionary (a copy of speecht5_tpu/data/dictionary.py,
which the port may not import).

Behavioral spec: fairseq Dictionary as used by the reference tasks
(reference tasks/speecht5.py:298-322): file lines are "<symbol> <count>",
specials prepended as <s>=0, <pad>=1, </s>=2, <unk>=3; SpeechT5 additionally
appends <mask> and <ctc_blank> (tasks/speecht5.py loads dicts then adds
the mask/blank symbols).
"""

from __future__ import annotations

from typing import Iterable, List, Optional


class Dictionary:
    def __init__(
        self,
        bos: str = "<s>",
        pad: str = "<pad>",
        eos: str = "</s>",
        unk: str = "<unk>",
    ):
        self.symbols: List[str] = []
        self.counts: List[int] = []
        self.indices = {}
        self.bos_word, self.pad_word, self.eos_word, self.unk_word = bos, pad, eos, unk
        for s in (bos, pad, eos, unk):
            self.add_symbol(s)
        self.bos_index = self.indices[bos]
        self.pad_index = self.indices[pad]
        self.eos_index = self.indices[eos]
        self.unk_index = self.indices[unk]

    def __len__(self):
        return len(self.symbols)

    def __getitem__(self, idx):
        return self.symbols[idx] if idx < len(self.symbols) else self.unk_word

    def add_symbol(self, word: str, n: int = 1) -> int:
        if word in self.indices:
            idx = self.indices[word]
            self.counts[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.counts.append(n)
        return idx

    def index(self, word: str) -> int:
        return self.indices.get(word, self.unk_index)

    @classmethod
    def load(cls, path: str, extra_special_symbols: Optional[Iterable[str]] = None
             ) -> "Dictionary":
        d = cls()
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                sym, _, cnt = line.rpartition(" ")
                if not sym:
                    sym, cnt = cnt, "1"
                try:
                    n = int(cnt)
                except ValueError:
                    sym, n = line, 1
                d.add_symbol(sym, n)
        if extra_special_symbols:
            for s in extra_special_symbols:
                d.add_symbol(s)
        return d

    def save(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            for sym, cnt in zip(self.symbols[4:], self.counts[4:]):
                f.write(f"{sym} {cnt}\n")

    def encode_line(self, line: str, append_eos: bool = True) -> List[int]:
        ids = [self.index(tok) for tok in line.split()]
        if append_eos:
            ids.append(self.eos_index)
        return ids

    def string(self, ids, remove_special: bool = True) -> str:
        toks = []
        skip = {self.bos_index, self.pad_index, self.eos_index} if remove_special else set()
        for i in ids:
            i = int(i)
            if i in skip:
                continue
            toks.append(self[i])
        return " ".join(toks)


def letters_to_text(tokens: str) -> str:
    """fairseq letter-dict convention: '|' is the word separator."""
    return tokens.replace(" ", "").replace("|", " ").strip()


def load_cli_dictionary(dict_path=None, vocab_size=None):
    """Shared CLI dictionary/config plumbing (train/evaluate/convert):
    returns (dictionary_or_None, cfg_kwargs with vocab_size/blank_id)."""
    cfg_kw = {}
    dictionary = None
    if dict_path:
        dictionary = Dictionary.load(
            dict_path, extra_special_symbols=["<mask>", "<ctc_blank>"]
        )
        cfg_kw["vocab_size"] = len(dictionary)
        cfg_kw["blank_id"] = dictionary.index("<ctc_blank>")
    elif vocab_size:
        cfg_kw["vocab_size"] = vocab_size
    return dictionary, cfg_kw
