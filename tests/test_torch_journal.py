"""The port's write-ahead journal against the JAX package's: the same file
format byte for byte, so a journal that either package writes replays in
the other — torn tails, CRC corruption, compaction, snapshots by kind and
packed arrays included.  Pure Python and NumPy on both sides."""

import json
import os

import numpy as np
import pytest

from ai_crypto_trader_tpu.utils import journal as jax_journal
from ai_crypto_trader_tpu_torch.utils import journal as port_journal

PACKAGES = {"jax": jax_journal, "port": port_journal}
DIRECTIONS = [("jax", "port"), ("port", "jax"), ("port", "port")]


def _clock():
    t = {"now": 1_700_000_000.0}

    def now():
        t["now"] += 0.25
        return t["now"]
    return now


def _write(pkg, path, n=5, fsync_every=2):
    j = PACKAGES[pkg].WriteAheadJournal(path, fsync_every=fsync_every, now_fn=_clock())
    for i in range(n):
        j.append("tick", {"i": i, "px": 100.5 + i, "tags": ["a", i]})
    return j


def test_the_same_appends_write_the_same_bytes(tmp_path):
    paths = {}
    for pkg in PACKAGES:
        paths[pkg] = str(tmp_path / f"{pkg}.journal")
        j = _write(pkg, paths[pkg])
        j.append("intent", {"coid": "x", "qty": 0.125}, flush=True)
        j.compact({"state": [1, 2, 3]})
        j.append("after", {"ok": True})
        j.close()
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_roundtrip_replays_in_the_other_package(tmp_path, writer, reader):
    path = str(tmp_path / "trades.journal")
    _write(writer, path).close()
    got, stats = PACKAGES[reader].replay(path)
    want, want_stats = PACKAGES[writer].replay(path)
    assert got == want and stats == want_stats
    assert [r["data"]["i"] for r in got] == list(range(5))
    assert stats == {"total_lines": 5, "replayed": 5, "corrupt_records": 0, "torn_tail": False}
    # sequence numbers continue across packages
    j = PACKAGES[reader].WriteAheadJournal(path)
    assert j.append("next", {}) == 6
    j.close()


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_torn_tail_is_dropped_and_reopen_appends_cleanly(tmp_path, writer, reader):
    path = str(tmp_path / "torn.journal")
    j = PACKAGES[writer].WriteAheadJournal(path, fsync_every=100)
    j.append("keep", {"i": 0}, flush=True)
    j.append("torn", {"i": 1})
    j.simulate_crash(torn_tail_bytes=20)           # half a record on disk
    records, stats = PACKAGES[reader].replay(path)
    assert [r["kind"] for r in records] == ["keep"]
    assert stats["torn_tail"] and stats["corrupt_records"] == 0
    j2 = PACKAGES[reader].WriteAheadJournal(path)
    assert j2.replay_stats["torn_tail"]
    j2.append("fresh", {"i": 2}, flush=True)
    j2.close()
    records, stats = PACKAGES[writer].replay(path)
    assert [r["kind"] for r in records] == ["keep", "fresh"]
    assert not stats["torn_tail"] and stats["corrupt_records"] == 0


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_crc_corruption_mid_file_is_skipped_and_counted(tmp_path, writer, reader):
    path = str(tmp_path / "rot.journal")
    _write(writer, path).close()
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    rec = json.loads(lines[2])
    rec["data"]["px"] = 999.0                       # bit rot under an unchanged CRC
    lines[2] = json.dumps(rec) + "\n"
    lines[3] = "{not json\n"
    with open(path, "w") as f:
        f.writelines(lines)
    records, stats = PACKAGES[reader].replay(path)
    assert [r["data"]["i"] for r in records] == [0, 1, 4]
    assert stats == {"total_lines": 5, "replayed": 3, "corrupt_records": 2, "torn_tail": False}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_compaction_replays_as_one_snapshot(tmp_path, writer, reader):
    path = str(tmp_path / "compact.journal")
    j = _write(writer, path)
    j.compact({"positions": {"BTCUSDC": 0.5}})
    j.append("later", {"n": 1}, flush=True)
    j.close()
    assert not os.path.exists(path + ".compact")
    records, _ = PACKAGES[reader].replay(path)
    assert [r["kind"] for r in records] == ["snapshot", "later"]
    assert records[0]["data"] == {"positions": {"BTCUSDC": 0.5}}
    assert records[0]["seq"] == 6 and records[1]["seq"] == 7


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_snapshot_journal_load_snapshot_by_kind(tmp_path, writer, reader):
    path = str(tmp_path / "snap.journal")
    arr = np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0
    sj = PACKAGES[writer].SnapshotJournal(path, compact_every=3, kind="pbt_lineage",
                                          now_fn=_clock())
    for g in range(5):
        sj.write({"generation": g, "a": PACKAGES[writer].pack_array(arr + g)})
    sj.close()
    payload, stats = PACKAGES[reader].load_snapshot(path, kind="pbt_lineage")
    assert payload["generation"] == 4 and stats["corrupt_records"] == 0
    np.testing.assert_array_equal(PACKAGES[reader].unpack_array(payload["a"]), arr + 4)
    # another stream's kind finds only the post-compaction snapshot record
    other, _ = PACKAGES[reader].load_snapshot(path, kind="fleet_state")
    assert other["generation"] == 2
    records, _ = PACKAGES[reader].replay(path)
    assert [r["kind"] for r in records] == ["snapshot", "pbt_lineage", "pbt_lineage"]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_packed_arrays_cross_and_refuse_bit_rot(writer, reader):
    rng = np.random.default_rng(3)
    for a in (rng.standard_normal((2, 3)).astype(np.float32), np.arange(5, dtype=np.int64),
              np.array([True, False]), np.frombuffer(b"\x01\x02\x03", np.uint8)):
        rec = PACKAGES[writer].pack_array(a)
        got = PACKAGES[reader].unpack_array(json.loads(json.dumps(rec)))
        assert got.dtype == a.dtype and np.array_equal(got, a) and got.flags.writeable
    bad = dict(PACKAGES[writer].pack_array(np.ones(3, np.float32)))
    bad["crc"] = (bad["crc"] + 1) & 0xFFFFFFFF
    with pytest.raises(ValueError, match="crc"):
        PACKAGES[reader].unpack_array(bad)


def test_crash_loses_only_the_unflushed_batch(tmp_path):
    path = str(tmp_path / "wal.journal")
    j = port_journal.WriteAheadJournal(path, fsync_every=100)
    j.append("intent", {"coid": "x"}, flush=True)
    j.append("lazy", {"n": 1})
    j.simulate_crash()
    records, stats = jax_journal.replay(path)
    assert [r["kind"] for r in records] == ["intent"] and not stats["torn_tail"]
    with pytest.raises(IsADirectoryError):
        port_journal.replay(str(tmp_path))
