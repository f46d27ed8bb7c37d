"""`fix`: rebuild a volume .idx by scanning its .dat (reference:
`weed/command/fix.go`). The port's copy of `seaweedfs_tpu/command/fix.py`."""

from __future__ import annotations

import argparse

def run(args: list[str]) -> int:
    p = argparse.ArgumentParser(prog="fix")
    p.add_argument("-dir", default=".")
    p.add_argument("-collection", default="")
    p.add_argument("-volumeId", type=int, required=True)
    opts = p.parse_args(args)

    from seaweedfs_tpu_torch.storage import idx as idx_mod
    from seaweedfs_tpu_torch.storage.needle import (
        Needle,
        needle_body_length,
    )
    from seaweedfs_tpu_torch.storage.super_block import SUPER_BLOCK_SIZE, SuperBlock
    from seaweedfs_tpu_torch.storage.types import NEEDLE_HEADER_SIZE, TOMBSTONE_FILE_SIZE
    from seaweedfs_tpu_torch.storage.volume import volume_file_name

    base = volume_file_name(opts.dir, opts.collection, opts.volumeId)
    dat = open(base + ".dat", "rb").read()
    sb = SuperBlock.from_bytes(dat[:SUPER_BLOCK_SIZE])
    offset = sb.block_size()
    entries: dict[int, tuple[int, int]] = {}
    scanned = 0
    while offset + NEEDLE_HEADER_SIZE <= len(dat):
        n = Needle()
        n.parse_header(dat[offset : offset + NEEDLE_HEADER_SIZE])
        body_len = needle_body_length(max(n.size, 0), sb.version)
        if n.size > 0:
            entries[n.id] = (offset, n.size)
        else:
            entries[n.id] = (offset, TOMBSTONE_FILE_SIZE)
        offset += NEEDLE_HEADER_SIZE + body_len
        scanned += 1
    with open(base + ".idx", "wb") as f:
        for key in sorted(entries):
            off, size = entries[key]
            if size == TOMBSTONE_FILE_SIZE:
                f.write(idx_mod.entry_to_bytes(key, 0, TOMBSTONE_FILE_SIZE))
            else:
                f.write(idx_mod.entry_to_bytes(key, off, size))
    print(f"scanned {scanned} needles -> {base}.idx ({len(entries)} keys)")
    return 0
