"""fairseq-format Dictionary (vocabulary).

Compatible with the reference's ``fairseq.data.Dictionary`` text format: one
``<token> <count>`` pair per line, with the four special symbols implicitly
occupying indices bos=0, pad=1, eos=2, unk=3 (fairseq/fairseq/data/
dictionary.py).  Index compatibility matters because the CAAT transducer uses
``bos`` as the blank label and the published spm vocab files are in this
format.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, List


class Dictionary:
    def __init__(self, bos="<s>", pad="<pad>", eos="</s>", unk="<unk>",
                 extra_special_symbols=None):
        self.symbols: List[str] = []
        self.count: List[int] = []
        self.indices = {}
        self.bos_word, self.pad_word, self.eos_word, self.unk_word = (
            bos, pad, eos, unk)
        self.bos_index = self.add_symbol(bos)
        self.pad_index = self.add_symbol(pad)
        self.eos_index = self.add_symbol(eos)
        self.unk_index = self.add_symbol(unk)
        for s in extra_special_symbols or []:
            self.add_symbol(s)
        self.nspecial = len(self.symbols)

    def __len__(self):
        return len(self.symbols)

    def __getitem__(self, idx):
        return self.symbols[idx] if idx < len(self.symbols) else self.unk_word

    def bos(self): return self.bos_index
    def pad(self): return self.pad_index
    def eos(self): return self.eos_index
    def unk(self): return self.unk_index

    def add_symbol(self, word, n=1):
        if word in self.indices:
            idx = self.indices[word]
            self.count[idx] += n
            return idx
        idx = len(self.symbols)
        self.indices[word] = idx
        self.symbols.append(word)
        self.count.append(n)
        return idx

    def index(self, word):
        return self.indices.get(word, self.unk_index)

    def encode(self, tokens: Iterable[str], append_eos=True) -> List[int]:
        ids = [self.index(t) for t in tokens]
        if append_eos:
            ids.append(self.eos_index)
        return ids

    def decode(self, ids, strip_special=True) -> List[str]:
        out = []
        for i in ids:
            i = int(i)
            if strip_special and i < self.nspecial:
                continue
            out.append(self[i])
        return out

    @classmethod
    def load(cls, path) -> "Dictionary":
        d = cls()
        for line in Path(path).read_text(encoding="utf-8").splitlines():
            line = line.rstrip()
            if not line:
                continue
            if " " in line:
                word, cnt = line.rsplit(" ", 1)
                try:
                    n = int(cnt)
                except ValueError:
                    word, n = line, 1
            else:
                word, n = line, 1
            d.add_symbol(word, n)
        return d

    def save(self, path) -> None:
        lines = [f"{s} {c}" for s, c in
                 zip(self.symbols[self.nspecial:], self.count[self.nspecial:])]
        Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")
