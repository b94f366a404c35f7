"""The multi-device path (__graft_entry__.dryrun_multichip) on four virtual
CPU devices equals the same computation on one device."""

import importlib


def test_dryrun_four_devices_matches_one():
    ge = importlib.import_module("__graft_entry__")
    rec = ge.dryrun_multichip(4, per_device=2, train_frames=128,
                              decode_frames=16, num_sentences=10)
    assert rec["devices"] == 4 and rec["batch"] == 8
    assert rec["train"]["max_rel_err"] <= 1e-4
    assert rec["fmllr"]["max_rel_err"] <= 1e-4
    assert len(rec["lattice"]["arcs_per_device"]) == 4
