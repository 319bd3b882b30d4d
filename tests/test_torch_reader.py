"""The port's array reading of deck blocks (modflow6_torch/utils/mf6io:
``reader.split_records``/``uniform_table``/``table_or_lines``, the list
columns of ``loader._list_columns``, the VERTICES/CELL2D arrays, UZF's
column tables) against the record-by-record parsing it replaces, on every
deck the port's tests write.

For every input file of every deck: the blocks, their indices and their
token records equal the reference's line parser's (modflow6_tpu's
``BlockFile``), OPEN/CLOSE records spliced alike; every block's tokens
and per-record counts from one split equal the per-record tokenizer's;
every PERIOD block read as columns (for each cellid width, value count,
auxiliary column and boundname setting that the block can hold) equals
``list_rows``, and as the SWF stress packages' columns their record loop;
every uniform block's columns equal the per-record columns;
and every DISV/DISV2D grid file gives the reference's vertices and rings.
"""

import os

import numpy as np
import pytest

from test_regression_decks import build_adv01, build_npf01
from test_torch_advanced_decks import _lak_maw_deck
from test_torch_apt import apt_deck
from test_torch_exchange import write_exchange_mvr_deck
from test_torch_gwe import gwe_deck
from test_torch_gwt_decks import small_gwt_deck
from test_torch_mvr import write_mvr_deck
from test_torch_newton import build_newton01
from test_torch_obs import _heads_tas_export
from test_torch_packages import write_general_deck
from test_torch_prt_decks import disv_deck, stop_deck, swarm_deck, uniform_deck
from test_torch_swf_decks import (chf_normal_depth_deck, chf_pcp_deck,
                                  disv2d_deck, olf_plane_deck, tree_deck)
from test_torch_timeseries import _ts_deck
from test_torch_uzf import write_uzf_deck
from modflow6_tpu.utils.mf6io import loader as jloader
from modflow6_tpu.utils.mf6io import reader as jreader
from modflow6_tpu.utils.mf6io import swf_loader as jswf_loader
from modflow6_torch.models.discretization import DisGrid, DisvGrid
from modflow6_torch.utils.mf6io import advanced_loader, loader, reader
from modflow6_torch.utils.mf6io import swf_loader


DECKS = {
    "npf01": lambda ws: build_npf01(ws, "b", 21, 21),
    "adv01": lambda ws: build_adv01(ws, "tvd"),
    "disv": lambda ws: write_general_deck(ws, "disv", nseg=2),
    "disu": lambda ws: write_general_deck(ws, "disu"),
    "lak_maw": _lak_maw_deck, "apt": apt_deck,
    "gwe": gwe_deck, "gwt": small_gwt_deck, "mvr": write_mvr_deck,
    "exchange": write_exchange_mvr_deck, "newton": build_newton01,
    "obs_tas_netcdf": _heads_tas_export, "ts": _ts_deck,
    "uzf": write_uzf_deck, "chf": chf_normal_depth_deck, "olf": olf_plane_deck,
    "chf_pcp": chf_pcp_deck, "chf_cxs": tree_deck, "olf_disv2d": disv2d_deck,
    "prt": uniform_deck, "prt_stop": stop_deck, "prt_disv": disv_deck,
    "prt_swarm": swarm_deck,
}
# cellid widths 3, 2 and 1 (DIS, DISV, DISU) over grids of any size
GRIDS = (DisGrid(3, 1000, 1000, None, None, None, None, None),
         DisvGrid(3, 10 ** 6, None, None, None, None, None, None, None, None),
         object())


def _input_files(ws):
    for root, _, files in os.walk(ws):
        for name in sorted(files):
            path = os.path.join(root, name)
            try:
                with open(path) as f:
                    f.read()
            except UnicodeDecodeError:
                continue            # a binary array file
            yield path


def _rows_or_none(records, grid, ncols, aux, bnames):
    try:
        return loader.list_rows(records, grid, ncols, aux, bnames)
    except (IndexError, ValueError):
        return None


def _check_list_block(records):
    """Every reading of ``records`` as a list block: columns equal rows."""
    fired = 0
    for grid in GRIDS:
        for ncols in (1, 2, 3):
            for aux in ([], ["A"]):
                for bnames in (False, True):
                    got = loader._list_columns(records, grid, ncols, aux,
                                               bnames)
                    if got is None:
                        continue
                    want = _rows_or_none(records, grid, ncols, aux, bnames)
                    assert want is not None and not want[3]
                    assert got == tuple(want[:3])
                    fired += 1
    return fired


def _swf_rows_or_none(records, kind, ncols, skip):
    """swf_loader._stress_rows' record loop on ``records``."""
    rows, nonzero = [], False
    try:
        for toks in map(reader.tokenize_line, records):
            node, nt = swf_loader._cellid(toks, 0, kind, 1000)
            nonzero |= bool(skip and int(toks[nt]) != 0)
            rows.append((node, *(float(toks[nt + skip + j])
                                 for j in range(ncols))))
    except (IndexError, ValueError):
        return None
    return rows, nonzero


def _check_swf_block(records):
    """The SWF stress packages' columns equal their record loop."""
    fired = 0
    for kind in ("disv1d", "dis2d"):
        for ncols in (1, 3):
            for skip in (0, 1):
                got = swf_loader._stress_columns(records, kind, 1000, ncols,
                                                 skip)
                if got is None:
                    continue
                assert got == _swf_rows_or_none(records, kind, ncols, skip)
                fired += 1
    return fired


def _check_columns(block):
    """A uniform block's columns equal the per-record fields."""
    table = reader.table_or_lines(block.raw)
    if not isinstance(table, reader.TokenTable):
        return
    for c in range(table.width):
        for kind in (float, int):
            def col(lines):
                try:
                    return advanced_loader.record_column(lines, c, "x", kind)
                except NotImplementedError:
                    return "series"
            got, want = col(table), col(block.lines)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("deck", list(DECKS))
def test_array_reading_equals_the_line_parser(deck, tmp_path):
    ws = str(tmp_path)
    DECKS[deck](ws)
    list_blocks = 0
    for path in _input_files(ws):
        try:
            ref = jreader.BlockFile(path)
        except Exception:
            continue                # not a block file (an array file)
        got = reader.BlockFile(path)
        assert [(b.name, b.index, b.lines) for b in got.blocks] == \
            [(b.name, b.index, b.lines) for b in ref.blocks], path
        for b, rb in zip(got.blocks, ref.blocks):
            split = reader.split_records(b.raw)
            if split is not None:
                toks, counts = split
                assert toks == [t for line in b.lines for t in line]
                assert counts.tolist() == [len(line) for line in b.lines]
            _check_columns(b)
            if b.name == "PERIOD":
                records = got.records(b)
                assert [reader.tokenize_line(s) for s in records] == \
                    ref.expand_open_close(rb)
                list_blocks += _check_list_block(records)
                list_blocks += _check_swf_block(b.raw)
        if got.get("CELL2D") is not None and got.get("VERTICES") is not None:
            if got.dimensions().get("NCPL"):
                g, jg = loader.load_disv(path), jloader.load_disv(path)
                np.testing.assert_array_equal(g.vertices,
                                              np.asarray(jg.vertices))
                assert [r.tolist() for r in g.cell_verts] == \
                    [list(np.asarray(r)) for r in jg.cell_verts]
            else:
                g = swf_loader._load_disv2d(path, ws)
                jg = jswf_loader._load_disv2d(path, ws)
                np.testing.assert_array_equal(g.base.vertices,
                                              np.asarray(jg.base.vertices))
                np.testing.assert_array_equal(g.base.xc, jg.base.xc)
                assert [r.tolist() for r in g.base.cell_verts] == \
                    [list(np.asarray(r)) for r in jg.base.cell_verts]
    assert deck in ("npf01", "adv01") or list_blocks


def test_records_edge_cases(tmp_path):
    """Quotes, comments, OPEN/CLOSE, mixed widths and series names: the
    array readers step aside and the line parser reads them."""
    sub = tmp_path / "rows.txt"
    sub.write_text("# a comment\n1 1 1 2.5\n\n1 1 2 3.5 name\n")
    path = tmp_path / "m.wel"
    path.write_text("BEGIN OPTIONS\n  BOUNDNAMES\nEND OPTIONS\n"
                    "BEGIN PERIOD 1\n  OPEN/CLOSE rows.txt\n"
                    "  1 2 1 'quoted name' x\n  ! bang comment\n"
                    "  // slash comment\n  1 2 2 SERIES\n"
                    "  begin_not_a_block 1\nEND PERIOD\n")
    got = reader.BlockFile(str(path))
    ref = jreader.BlockFile(str(path))
    assert [(b.name, b.lines) for b in got.blocks] == \
        [(b.name, b.lines) for b in ref.blocks]
    records = got.records(got.get("PERIOD"))
    assert [reader.tokenize_line(s) for s in records] == \
        ref.expand_open_close(ref.get("PERIOD"))
    assert reader.split_records(records) is None        # the quotes
    assert loader._list_columns(records[:2], GRIDS[0], 1, [], True) is None
    uniform = ["1 1 1 2.5", "1 1 2 SERIES"]
    assert loader._list_columns(uniform, GRIDS[0], 1, [], False) is None
    entries, names, _, refs = loader.list_rows(uniform, GRIDS[0], 1, [],
                                               False)
    assert refs == [(1, 0, "SERIES")] and entries[1] == (1, 0.0)
