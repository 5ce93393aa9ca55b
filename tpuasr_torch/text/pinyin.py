"""Canonical toneless Mandarin pinyin syllable inventory (the port's own copy
of ``tpuasr/text/pinyin.py``).

A BZNSYP vocabulary file holds the ~406 syllables its corpus uses
(`python -m tpuasr_torch.tools.gen_vocab`); without a file the tokenizer
takes this full standard table of 409 syllables (the corpus vocabulary is a
subset), generated from the initial x final composition table of Putonghua.
"""

_TABLE = {
    # initial -> finals it combines with
    "": "a o e ai ei ao ou an en ang eng er yi ya ye yao you yan yin yang ying yong "
        "wu wa wo wai wei wan wen wang weng yu yue yuan yun o",
    "b": "a o ai ei ao an en ang eng i ie iao ian in ing u",
    "p": "a o ai ei ao ou an en ang eng i ie iao ian in ing u",
    "m": "a o e ai ei ao ou an en ang eng i ie iao iu ian in ing u",
    "f": "a o ei ou an en ang eng u",
    "d": "a e ai ei ao ou an en ang eng i ia ie iao iu ian ing u uo ui uan un ong",
    "t": "a e ai ao ou an ang eng i ie iao ian ing u uo ui uan un ong",
    "n": "a e ai ei ao ou an en ang eng i ie iao iu ian in iang ing u uo uan ong v ve",
    "l": "a o e ai ei ao ou an ang eng i ia ie iao iu ian in iang ing u uo uan un ong v ve",
    "g": "a e ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong",
    "k": "a e ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong",
    "h": "a e ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong",
    "j": "i ia ie iao iu ian in iang ing iong u ue uan un",
    "q": "i ia ie iao iu ian in iang ing iong u ue uan un",
    "x": "i ia ie iao iu ian in iang ing iong u ue uan un",
    "zh": "a e i ai ei ao ou an en ang eng u ua uo uai ui uan un uang ong",
    "ch": "a e i ai ao ou an en ang eng u ua uo uai ui uan un uang ong",
    "sh": "a e i ai ei ao ou an en ang eng u ua uo uai ui uan un uang",
    "r": "e i ao ou an en ang eng u ua uo ui uan un ong",
    "z": "a e i ai ei ao ou an en ang eng u uo ui uan un ong",
    "c": "a e i ai ao ou an en ang eng u uo ui uan un ong",
    "s": "a e i ai ao ou an en ang eng u uo ui uan un ong",
}

# j/q/x + u are written without umlaut; the y-/w- rows in "" are already surface
# forms. nv/lv written with v (as BZNSYP labels do).


def _build():
    syl = []
    seen = set()
    for init, finals in _TABLE.items():
        for fin in finals.split():
            s = init + fin
            if s not in seen:
                seen.add(s)
                syl.append(s)
    return tuple(sorted(syl))


PINYIN_SYLLABLES = _build()


def write_vocab(path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for s in PINYIN_SYLLABLES:
            f.write(s + "\n")
