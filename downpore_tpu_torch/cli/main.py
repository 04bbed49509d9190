"""Entry point: ``python -m downpore_tpu_torch.cli <command> [-flag value
...]`` with the reference binary's command-line shape (ref:
downpore.go:53-92).  Registers the JAX CLI's nine commands in its order:
trim, map, overlap and correct on the torch engine, and the host commands
subseq, consensus, align, kmers and version."""
from __future__ import annotations

import sys

from .framework import aligned_print, parse_argv


def get_commands():
    """The commands, in the JAX CLI's order."""
    from .consensus_command import AlignCommand, ConsensusCommand
    from .correct_command import CorrectCommand
    from .kmers_command import KmersCommand
    from .map_command import MapCommand
    from .overlap_command import OverlapCommand
    from .subseq_command import SubSeqCommand
    from .trim_command import TrimCommand
    from .version_command import VersionCommand
    return [TrimCommand(), MapCommand(), OverlapCommand(), SubSeqCommand(),
            ConsensusCommand(), AlignCommand(), CorrectCommand(),
            KmersCommand(), VersionCommand()]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    coms = get_commands()
    if not argv:
        print("Available commands:\n help <command> "
              "Describe the command and its arguments")
        for com in coms:
            print(" " + com.name)
        return 0
    if argv[0] == "help":
        if len(argv) > 1:
            for com in coms:
                if com.name == argv[1]:
                    lines = []
                    for arg, default in com.args.items():
                        a = com.alias.get(arg)
                        lines.append(["-" + arg, "-" + a if a else "",
                                      com.desc[arg],
                                      "(default:" + default + ")"])
                    aligned_print(lines)
                    return 0
        print("Usage: downpore help <command>\n"
              "To see a list of available commands just run downpore")
        return 0
    for com in coms:
        if com.name == argv[0]:
            com.run(parse_argv(com, argv[1:]))
            return 0
    print("Available commands:\n help <command> "
          "Describe the command and its arguments")
    return 0


if __name__ == "__main__":
    sys.exit(main())
