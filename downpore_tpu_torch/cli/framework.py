"""The CLI command framework: flag names, defaults, descriptions and
auto-generated unambiguous-prefix aliases, mirroring the reference's
homegrown system (ref: commands/command.go:9-74, downpore.go:34-51) so the
command lines are drop-in compatible."""
from __future__ import annotations

import sys
from typing import Dict, List, Tuple


class Command:
    name = ""

    def __init__(self, names: List[str], defaults: List[str],
                 descriptions: List[str]):
        self.args, self.alias, self.desc = make_args(names, defaults,
                                                     descriptions)

    def run(self, args: Dict[str, str]):
        raise NotImplementedError


def make_args(names: List[str], defaults: List[str],
              descriptions: List[str]) -> Tuple[dict, dict, dict]:
    """Defaults map + minimal-prefix aliases (ref: commands/command.go:18-56).
    Aliases longer than 3 characters are not generated."""
    args = dict(zip(names, defaults))
    desc = dict(zip(names, descriptions))
    alias: Dict[str, str] = {}
    snames = sorted(names)
    i = 0
    while i < len(snames):
        if i == len(snames) - 1 or snames[i][0] != snames[i + 1][0]:
            alias[snames[i]] = snames[i][:1]
            i += 1
            continue
        j = i + 1
        min_len = 1
        while j < len(snames) and snames[j][0] == snames[i][0]:
            same = 1
            while (same < len(snames[j]) and same < len(snames[j - 1])
                   and snames[j][same] == snames[j - 1][same]):
                same += 1
            if same >= min_len:
                min_len = same + 1
            j += 1
        if min_len < 4:
            for n in snames[i:j]:
                alias[n] = n[:min_len]
        i = j
    return args, alias, desc


def parse_int(arg: str) -> int:
    try:
        return int(arg)
    except ValueError:
        sys.exit(f"Invalid integer argument value:{arg}")


def parse_float(arg: str) -> float:
    try:
        return float(arg)
    except ValueError:
        sys.exit(f"Invalid float argument value:{arg}")


def parse_bool(arg: str) -> bool:
    """Go-style: '1' or leading t/T (ref: commands/command.go:72-74)."""
    return arg == "1" or (len(arg) > 0 and arg[0] in "Tt")


def parse_argv(com: Command, argv: List[str]) -> Dict[str, str]:
    """-x value / --x value pairs with alias resolution
    (ref: downpore.go:34-51)."""
    args = dict(com.args)
    invert = {v: k for k, v in com.alias.items()}
    i = 0
    while i < len(argv):
        name = argv[i].lstrip("-")
        name = invert.get(name, name)
        if name not in args:
            sys.exit(f"Unrecognised argument:{name}")
        if i + 1 >= len(argv):
            sys.exit(f"Missing value for argument:{name}")
        args[name] = argv[i + 1]
        i += 2
    return args


def aligned_print(lines: List[List[str]]):
    widths: List[int] = []
    for line in lines:
        for i, part in enumerate(line):
            while len(widths) <= i:
                widths.append(0)
            widths[i] = max(widths[i], len(part))
    for line in lines:
        out = []
        for i, part in enumerate(line):
            out.append(part + " " * (widths[i] - len(part) + 2))
        print("".join(out).rstrip())
