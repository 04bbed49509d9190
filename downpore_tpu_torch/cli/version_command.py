"""The version command.  The reference has one too, but never registers it
in its CLI (ref: commands/version.go:10, downpore.go:54) — this one is
registered."""
from __future__ import annotations

from .framework import Command


class VersionCommand(Command):
    name = "version"

    def __init__(self):
        super().__init__([], [], [])

    def run(self, args):
        from .. import __version__
        print(f"downpore-tpu version {__version__} "
              "(capabilities of downpore 0.4.0)")
