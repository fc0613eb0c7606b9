"""The yardstick's counts: kernel operations and bytes, and FLOP conventions."""
