"""Backup / restore / GC (the port's copy of kaamer_tpu/index/backup.py).

The reference streams Badger backups of the kmer and protein stores to .bdg
files (backupdb.go:47-65) and restores them with db.Load + flatten + GC
(restoredb.go:52-88); its kcomb store must be rebuilt by re-indexing.  Our
artifact is a directory of immutable flat files, so backup/restore is a
verified file copy and nothing is lost (the index travels with the backup).

Value-log garbage collection (gcdb.go:26-45) has no equivalent work to do on
immutable arrays; gc_db validates the artifact and reports reclaimable space
(always zero), keeping the CLI surface."""

from __future__ import annotations

import os
import shutil


def _copy_tree(src_dir: str, out_dir: str) -> None:
    """Copy the artifact's files AND shard subdirectories (shard-built
    indexes live under <db>/shardNN/, index/build.py)."""
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(src_dir):
        src = os.path.join(src_dir, name)
        if os.path.isfile(src):
            shutil.copy2(src, os.path.join(out_dir, name))
        elif os.path.isdir(src):
            _copy_tree(src, os.path.join(out_dir, name))


def backup_db(db_path: str, out_path: str) -> None:
    if not os.path.exists(os.path.join(db_path, "meta.json")):
        raise ValueError(f"{db_path} is not a kaamer-tpu database")
    _copy_tree(db_path, out_path)


def restore_db(backup_path: str, out_path: str) -> None:
    if not os.path.exists(os.path.join(backup_path, "meta.json")):
        raise ValueError(f"{backup_path} is not a kaamer-tpu backup")
    _copy_tree(backup_path, out_path)
    # validate the restored artifact loads
    from . import artifact

    artifact.load_db(out_path)


def gc_db(db_path: str, iterations: int = 100, ratio: float = 0.5) -> int:
    """Validate the artifact; immutable flat arrays never hold garbage, so
    this reports 0 reclaimable bytes (CLI-surface parity with gcdb.go)."""
    from . import artifact

    artifact.load_db(db_path)
    return 0
