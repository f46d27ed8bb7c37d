"""FilerStore SPI + built-in stores (reference: `weed/filer/filerstore.go:21-44`).

The port's copy of `seaweedfs_tpu/filer/filerstore.py` with its two
built-in stores: an in-memory store and an embedded SQL store (sqlite3,
mirroring the abstract_sql pattern that backs the reference's
mysql/postgres/sqlite stores). The JAX package's other backends (lsm,
leveldb, etcd, redis, mysql, postgres) are not ported yet.
"""

from __future__ import annotations

import json
import sqlite3
import threading
from typing import Iterator

from .entry import Entry


class FilerStore:
    """SPI: insert/update/find/delete/list (+ kv for cluster metadata)."""

    name = "abstract"

    @staticmethod
    def split_path(full_path: str) -> tuple[str, str]:
        """ONE root convention for every store: the root entry "/" lives
        under (directory "/", name "/") — and because of that, stores
        whose listing is a scan over (directory, name) rows or a key
        prefix MUST exclude the root entry when listing "/" (it is not
        its own child; see list_should_skip). Three stores previously had
        private near-copies of this helper with divergent root handling,
        which made etcd/sql/redis list "/" inside itself."""
        if full_path == "/":
            return "/", "/"
        d, _, n = full_path.rpartition("/")
        return d or "/", n

    @staticmethod
    def list_should_skip(dir_path: str, entry: Entry) -> bool:
        """True for the root self-row when listing "/" (shared by every
        store whose storage model would otherwise return it)."""
        return entry.full_path == dir_path

    def insert_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def update_entry(self, entry: Entry) -> None:
        raise NotImplementedError

    def find_entry(self, full_path: str) -> Entry | None:
        raise NotImplementedError

    def delete_entry(self, full_path: str) -> None:
        raise NotImplementedError

    def delete_folder_children(self, full_path: str) -> None:
        for child in list(self.list_entries(full_path, "", True, 1 << 31)):
            if child.is_directory:
                self.delete_folder_children(child.full_path)
            self.delete_entry(child.full_path)

    def list_entries(
        self, dir_path: str, start_from: str, inclusive: bool, limit: int
    ) -> Iterator[Entry]:
        raise NotImplementedError

    def kv_put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def kv_get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def kv_delete(self, key: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemoryStore(FilerStore):
    name = "memory"

    def __init__(self) -> None:
        self._entries: dict[str, Entry] = {}
        self._kv: dict[str, bytes] = {}
        self._lock = threading.RLock()

    def insert_entry(self, entry: Entry) -> None:
        with self._lock:
            self._entries[entry.full_path] = entry

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        return self._entries.get(full_path)

    def delete_entry(self, full_path: str) -> None:
        with self._lock:
            self._entries.pop(full_path, None)

    def list_entries(self, dir_path: str, start_from: str, inclusive: bool, limit: int):
        prefix = dir_path.rstrip("/") + "/"
        if dir_path == "/":
            prefix = "/"
        with self._lock:
            names = sorted(
                p for p in self._entries
                if p.startswith(prefix) and p != dir_path and "/" not in p[len(prefix):]
            )
        count = 0
        for p in names:
            name = p[len(prefix):]
            if start_from:
                if inclusive and name < start_from:
                    continue
                if not inclusive and name <= start_from:
                    continue
            if count >= limit:
                return
            e = self._entries.get(p)
            if e is not None:
                count += 1
                yield e

    def kv_put(self, key: str, value: bytes) -> None:
        self._kv[key] = value

    def kv_get(self, key: str) -> bytes | None:
        return self._kv.get(key)

    def kv_delete(self, key: str) -> None:
        self._kv.pop(key, None)


class SqliteStore(FilerStore):
    """Embedded SQL store — the abstract_sql pattern
    (`weed/filer/abstract_sql/abstract_sql_store.go`): rows keyed by
    (directory, name), JSON-serialized entry metadata."""

    name = "sqlite"

    def __init__(self, path: str) -> None:
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = threading.RLock()
        with self._lock:
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS filemeta ("
                " directory TEXT NOT NULL, name TEXT NOT NULL, meta TEXT NOT NULL,"
                " PRIMARY KEY (directory, name))"
            )
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv (k TEXT PRIMARY KEY, v BLOB)"
            )
            self._conn.commit()

    @staticmethod
    def _split(full_path: str) -> tuple[str, str]:
        # NOT split_path: sqlite's persisted rows key the root under
        # directory "" (pre-dating the shared convention), and changing
        # the key would orphan the root row in every existing database.
        # The "" directory also keeps the root out of "/" listings.
        if full_path == "/":
            return "", "/"
        d, _, n = full_path.rpartition("/")
        return d or "/", n

    def insert_entry(self, entry: Entry) -> None:
        d, n = self._split(entry.full_path)
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO filemeta (directory, name, meta) VALUES (?,?,?)",
                (d, n, json.dumps(entry.to_dict())),
            )
            self._conn.commit()

    update_entry = insert_entry

    def find_entry(self, full_path: str) -> Entry | None:
        d, n = self._split(full_path)
        with self._lock:
            row = self._conn.execute(
                "SELECT meta FROM filemeta WHERE directory=? AND name=?", (d, n)
            ).fetchone()
        return Entry.from_dict(json.loads(row[0])) if row else None

    def delete_entry(self, full_path: str) -> None:
        d, n = self._split(full_path)
        with self._lock:
            self._conn.execute(
                "DELETE FROM filemeta WHERE directory=? AND name=?", (d, n)
            )
            self._conn.commit()

    def list_entries(self, dir_path: str, start_from: str, inclusive: bool, limit: int):
        d = dir_path.rstrip("/") or "/"
        op = ">=" if inclusive else ">"
        with self._lock:
            rows = self._conn.execute(
                f"SELECT meta FROM filemeta WHERE directory=? AND name {op} ?"
                " ORDER BY name LIMIT ?",
                (d, start_from, limit),
            ).fetchall()
        for (meta,) in rows:
            yield Entry.from_dict(json.loads(meta))

    def kv_put(self, key: str, value: bytes) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO kv (k, v) VALUES (?,?)", (key, value)
            )
            self._conn.commit()

    def kv_get(self, key: str) -> bytes | None:
        with self._lock:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE k=?", (key,)
            ).fetchone()
        return row[0] if row else None

    def kv_delete(self, key: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM kv WHERE k=?", (key,))
            self._conn.commit()

    def close(self) -> None:
        self._conn.close()
