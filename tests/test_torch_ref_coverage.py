"""Guard: every case of the reference's device-path tests is held on the port.

A reference test file reaches the device path when it imports
``openwebrx_tpu.{ops,models,runtime,parallel}``.  Each such file is either

* carried (``CARRIED``): its cases live in a tests/test_torch_ref_*.py file
  under an outer class named after it (``test_ops_basic.py`` →
  ``TestOpsBasic``), with the reference's class and case names, and every
  case it leaves out is listed in ``LEFT_OUT`` with its reason; or
* held by a port test file written before the carried files (``HELD``),
  which runs its scenes on the port against the JAX package; its cases are
  pinned here, so a new one shows.  These are the golden parity file,
  whose scenes tests/test_torch_golden.py also runs on the card, and the
  three multi-device files, whose scenes need more than one card
  (tests/test_torch_parallel.py runs them over gloo ranks on the CPU).

A new such reference file, or a new case in one, that is neither carried
nor listed fails here.  The files are parsed as text (``ast``); nothing of
jax or of the JAX package is imported.
"""

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
DEVICE_PATH = re.compile(r"openwebrx_tpu\.(ops|models|runtime|parallel)\b"
                         r"|from openwebrx_tpu import [^\n]*\b(ops|models|runtime|parallel)\b")

# reference file → the port file that carries its device-path cases
CARRIED = {
    "test_ops_basic.py": "test_torch_ref_ops.py",
    "test_ops_fft.py": "test_torch_ref_ops.py",
    "test_ops_fir.py": "test_torch_ref_ops.py",
    "test_nr_schedule.py": "test_torch_ref_ops.py",
    "test_channelizer.py": "test_torch_ref_ops.py",
    "test_channelized_bank.py": "test_torch_ref_ops.py",
    "test_chains.py": "test_torch_ref_ops.py",
    "test_impairments.py": "test_torch_ref_secondary.py",
    "test_digimodes.py": "test_torch_ref_secondary.py",
    "test_cwskimmer.py": "test_torch_ref_secondary.py",
    "test_fax.py": "test_torch_ref_secondary.py",
    "test_sstv.py": "test_torch_ref_secondary.py",
    "test_sstv_vis.py": "test_torch_ref_secondary.py",
    "test_secondary_maritime_image.py": "test_torch_ref_secondary.py",
    "test_rds.py": "test_torch_ref_secondary.py",
    "test_digital_voice.py": "test_torch_ref_voice.py",
    "test_dmr_ysf.py": "test_torch_ref_voice.py",
    "test_dstar.py": "test_torch_ref_voice.py",
    "test_nxdn.py": "test_torch_ref_voice.py",
    "test_m17.py": "test_torch_ref_voice.py",
    "test_meta.py": "test_torch_ref_voice.py",
    "test_exec_meta.py": "test_torch_ref_voice.py",
    "test_exec_audio.py": "test_torch_ref_voice.py",
    "test_service_engine.py": "test_torch_ref_runtime.py",
    "test_passband.py": "test_torch_ref_runtime.py",
    "test_connector.py": "test_torch_ref_runtime.py",
    "test_pfb_serving.py": "test_torch_ref_serving.py",
    "test_pfb_interactive.py": "test_torch_ref_serving.py",
    "test_secondary_bank.py": "test_torch_ref_serving.py",
    "test_fanout.py": "test_torch_ref_serving.py",
    "test_server.py": "test_torch_ref_server.py",
}

_HOST = "host only: runs no device code of the port ({}); the module is a host copy " \
        "held to the reference by tests/test_torch_host_copy.py"
_FRAME = _HOST.format("the host frame layer fed symbols")

# reference file → {case: why it is not carried}
LEFT_OUT = {
    "test_ops_basic.py": {
        "TestIir::test_deemphasis_response":
            "host float math (deemphasis_coeffs) against scipy.signal.freqz; no tensor",
    },
    "test_ops_fft.py": {
        "TestWaterfall::test_params_math":
            "host arithmetic (waterfall_params); tests/test_torch_waterfall.py "
            "test_tone_bin_level_and_params holds it equal to the reference",
    },
    "test_ops_fir.py": {},
    "test_nr_schedule.py": {
        f"TestSchedules::{case}": _HOST.format("the service scheduler")
        for case in ("test_static_schedule", "test_sun_times_plausible",
                     "test_daylight_schedule_entries", "test_scheduler_activates_and_arms")
    },
    "test_channelizer.py": {},
    "test_channelized_bank.py": {},
    "test_chains.py": {
        "TestLiveControls::test_retune_no_recompile":
            "counts the entries of JAX's jit cache; the port runs its stages eagerly "
            "and compiles nothing a retune could add to",
    },
    "test_impairments.py": {},
    "test_digimodes.py": {
        "TestRtty::test_framer_roundtrip": _HOST.format("the RTTY framer fed bits"),
        "TestCw::test_decoder_direct": _HOST.format("the CW decoder fed an envelope"),
    },
    "test_cwskimmer.py": {
        "TestCwSkimmerHost::test_two_signals_decoded":
            _HOST.format("numpy STFT frames into the host skimmer"),
    },
    "test_fax.py": {},
    "test_sstv.py": {},
    "test_sstv_vis.py": {
        case: _HOST.format(
            "frequency traces at the chain's output rate into the host SSTV decoder")
        for case in ("TestVisDetection::test_scottie_s1_golden",
                     "TestVisDetection::test_martin_m2_vis",
                     "TestVisDetection::test_robot36_golden",
                     "TestVisDetection::test_wrong_parity_rejected",
                     "TestVisRearm::test_aborted_frame_rearms_vis")
    },
    "test_secondary_maritime_image.py": {},
    "test_rds.py": {
        **{f"TestLogical::{case}": _HOST.format("the RDS group layer fed bits")
           for case in ("test_checkword_offsets_distinct", "test_ps_and_radiotext",
                        "test_partial_ps_before_complete", "test_clock_time_group",
                        "test_resync_after_garbage")},
        "TestPhysical::test_waveform_roundtrip_with_noise_and_phase":
            _HOST.format("the RDS decoder fed a numpy-filtered baseband"),
    },
    "test_digital_voice.py": {
        "TestDvChain::test_chain_modes_present": "the factory's keys and a chain's class; "
                                                 "no tensor",
    },
    "test_dmr_ysf.py": {
        case: _FRAME for case in (
            "TestFec::test_hamming_15_11_roundtrip_and_correction",
            "TestFec::test_hamming_13_9_roundtrip_and_correction",
            "TestFec::test_golay_24_12_corrects_3_errors",
            "TestFec::test_golay_20_8_corrects_3_errors",
            "TestFec::test_viterbi_roundtrip_with_errors",
            "TestFec::test_rs_12_9",
            "TestBptc::test_roundtrip_and_single_errors",
            "TestDmrDecoder::test_voice_lc_header_decodes_talkgroup",
            "TestDmrDecoder::test_terminator_ends_call",
            "TestDmrDecoder::test_burst_survives_symbol_errors",
            "TestYsf::test_fich_roundtrip",
            "TestYsf::test_fich_survives_symbol_errors",
            "TestYsf::test_dch_roundtrip",
            "TestYsf::test_stream_decodes_callsigns",
            "TestSyncOrdering::test_data_burst_before_voice_burst_in_one_chunk",
            "TestEmbeddedLc::test_embedded_roundtrip_with_errors",
            "TestEmbeddedLc::test_checksum_rejects_garbage",
            "TestEmbeddedLc::test_mid_call_join_decodes_talker",
            "test_embedded_lc_dedup_with_color_code")
    },
    "test_dstar.py": {
        case: _FRAME for case in (
            "TestHeader::test_roundtrip", "TestHeader::test_viterbi_heals_channel_errors",
            "TestHeader::test_crc_rejects_garbage", "TestHeader::test_interleaver_bijective",
            "TestHeader::test_scrambler_self_inverse",
            "TestStream::test_header_and_message_from_bitstream",
            "TestStream::test_inverted_polarity", "TestStream::test_dibit_feed_surface",
            "TestCutTransmission::test_new_header_after_abrupt_cut")
    },
    "test_nxdn.py": {
        case: _FRAME for case in (
            "TestCodes::test_lich_roundtrip_and_violation",
            "TestCodes::test_sacch_roundtrip_with_errors",
            "TestCodes::test_sacch_crc_rejects_garbage",
            "TestStream::test_vcall_ids_across_superframe",
            "TestStream::test_tx_release_ends_call",
            "TestSuperframeIsolation::test_no_chimeric_ids_across_calls")
    },
    "test_m17.py": {
        case: _FRAME for case in (
            "TestCallsigns::test_base40_roundtrip", "TestCallsigns::test_broadcast",
            "TestLsf::test_encode_decode", "TestLsf::test_crc_rejects_corruption",
            "TestLsf::test_payload_roundtrip_with_channel_errors",
            "TestLich::test_chunks_reassemble", "TestLich::test_golay_heals_chunk_errors",
            "TestStream::test_lsf_frame_decodes",
            "TestStream::test_lich_reassembly_from_stream_frames")
    },
    "test_meta.py": {
        case: _HOST.format("the metadata parser") for case in (
            "TestMetaParser::test_ysf_position_lands_on_map",
            "TestMetaParser::test_dmr_talker_alias_callsign",
            "TestMetaParser::test_dmr_radioid_async_lookup",
            "TestMetaParser::test_dstar_dprs_position",
            "TestMetaParser::test_feed_line_tolerates_junk")
    },
    "test_exec_meta.py": {
        case: _HOST.format("metadata parsers and a subprocess") for case in (
            "TestDrmStatusMonitor::test_socket_json_lines_forwarded",
            "TestDabMeta::test_dablin_stderr_lines",
            "TestDabMeta::test_json_passthrough_strips_afc_keys",
            "TestDabMeta::test_afc_clamps_at_carrier_spacing",
            "TestHdrMeta::test_nrsc5_lines",
            "TestExecHandleMetaIntegration::test_pipeline_stderr_feeds_dab_parser")
    },
    "test_exec_audio.py": {},
    "test_service_engine.py": {},
    "test_passband.py": {},
    "test_connector.py": {
        case: _HOST.format("ConnectorSource over TCP and the host numpy helper "
                           "host_as_complex64")
        for case in ("test_connector_stream_and_control", "test_connector_s16_wire_optin")
    },
    "test_pfb_serving.py": {},
    "test_pfb_interactive.py": {
        f"TestCrossProgramJoin::{case}":
            "reads the JAX runtime's fused device→host transfer (pend['joined'], "
            "pend['segs']), a workaround for a device behind a network tunnel that the "
            "port does not have; tests/test_torch_device.py TestOneFetchPerBlock holds "
            "the port's one fetch a block"
        for case in ("test_waterfall_and_banks_share_one_transfer",
                     "test_single_program_skips_join")
    },
    "test_secondary_bank.py": {},
    "test_fanout.py": {},
    "test_server.py": {},
}

# reference file → (the port test file that holds it, its cases)
HELD = {
    "test_cluster.py": ("test_torch_parallel.py", (
        "test_distributed_receiver_in_process", "test_two_process_virtual_cluster")),
    "test_parallel.py": ("test_torch_parallel.py", (
        "TestHaloFir::test_matches_single_chip", "TestHaloFir::test_streaming_across_blocks",
        "TestChannelSharding::test_bank_sharded_over_channels")),
    "test_parity_golden.py": ("test_torch_golden.py", (
        "test_selector_iq_parity", "test_nfm_audio_parity_pre_agc",
        "test_am_audio_parity_pre_agc", "test_usb_audio_parity_pre_agc",
        "test_wfm_audio_parity", "test_full_chain_gain_matched_parity",
        "test_squelch_gates_quiet_channel", "test_lowpass_design_meets_csdr_spec",
        "test_bandpass_design_meets_csdr_spec", "test_selector_parity_vs_remez_oracle",
        "test_oracle_designs_agree", "test_impairment_parity",
        "test_full_chain_agc_parity_no_gain_matching")),
    "test_pod.py": ("test_torch_parallel.py", (
        "TestPodSharding::test_sharded_matches_unsharded",)),
}

CARRYING = sorted(set(CARRIED.values()))


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), str(path))


def _tests_of(body, prefix=""):
    """``Class::case`` (or ``case``) of the test functions in ``body``."""
    out = []
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.startswith("test"):
            out.append(prefix + node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            out += _tests_of(node.body, f"{prefix}{node.name}::")
    return out


def reference_cases(name: str) -> list[str]:
    return _tests_of(_tree(TESTS / name).body)


def outer_class(name: str) -> str:
    """``test_ops_basic.py`` → ``TestOpsBasic``."""
    return "Test" + "".join(w.capitalize() for w in name[len("test_"):-len(".py")].split("_"))


def carried_cases(name: str) -> list[str]:
    """The cases the carrying file holds for reference file ``name`` (none
    where it has no outer class for it)."""
    tree = _tree(TESTS / CARRIED[name])
    outer = [n for n in tree.body if isinstance(n, ast.ClassDef)
             and n.name == outer_class(name)]
    assert len(outer) <= 1, f"{CARRIED[name]} has two classes {outer_class(name)}"
    return _tests_of(outer[0].body) if outer else []


def device_path_files() -> set[str]:
    return {p.name for p in TESTS.glob("test_*.py")
            if not p.name.startswith("test_torch_") and DEVICE_PATH.search(p.read_text())}


def test_every_device_path_file_is_carried_or_held():
    files = device_path_files()
    assert not set(CARRIED) & set(HELD)
    assert files == set(CARRIED) | set(HELD), (
        f"unmapped: {sorted(files - set(CARRIED) - set(HELD))}, "
        f"stale: {sorted((set(CARRIED) | set(HELD)) - files)}")
    assert set(LEFT_OUT) == set(CARRIED)


@pytest.mark.parametrize("name", sorted(CARRIED))
def test_every_case_is_carried_or_listed(name):
    """Each case of the reference file is carried under its own name, or
    listed in ``LEFT_OUT`` with a reason: never both, never neither."""
    ref = set(reference_cases(name))
    carried = set(carried_cases(name))
    left = set(LEFT_OUT[name])
    assert not carried - ref, f"carried cases the reference lacks: {sorted(carried - ref)}"
    assert not left - ref, f"listed cases the reference lacks: {sorted(left - ref)}"
    assert not carried & left, f"carried and listed: {sorted(carried & left)}"
    assert ref == carried | left, f"neither carried nor listed: {sorted(ref - carried - left)}"
    assert all(LEFT_OUT[name].values())


@pytest.mark.parametrize("name", sorted(HELD))
def test_held_files_keep_their_cases(name):
    """A reference file held by an earlier port test file has exactly the
    cases pinned here: a new one must be carried or listed."""
    port, cases = HELD[name]
    assert (TESTS / port).is_file()
    assert sorted(reference_cases(name)) == sorted(cases)


@pytest.mark.parametrize("name", [*CARRYING, "torch_ref_device.py", "torch_ref_helpers.py"])
def test_carried_files_import_no_jax(name):
    """The carried files run on the card's machine, which has no jax: no
    import of jax or of the JAX package (``openwebrx_tpu``)."""
    bad = []
    for node in ast.walk(_tree(TESTS / name)):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods = [node.module]
        bad += [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "openwebrx_tpu")]
    assert not bad, bad


def test_carried_cases_run_on_both_devices():
    """Every carried case takes the ``device`` fixture (cpu and the card)."""
    missing = []
    for name in CARRYING:
        for node in ast.walk(_tree(TESTS / name)):
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
                if "device" not in [a.arg for a in node.args.args]:
                    missing.append(f"{name}::{node.name}")
    assert not missing, missing


def test_chip_smoke_runs_the_carried_files():
    """chip_smoke.py phase 9b runs every carrying file among the card tests."""
    tree = _tree(REPO / "chip_smoke.py")
    args = next(ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", "") == "CARD_TESTS_ARGS" for t in n.targets))
    assert {"--noconftest", "-m", "cuda"} <= set(args)
    assert {f"tests/{name}" for name in CARRYING} <= set(args)


def test_carried_files_collect_without_jax():
    """The card's command collects the carried files in an interpreter where
    jax cannot be imported and without tests/conftest.py, loading nothing of
    the JAX package."""
    script = (
        "import sys\n"
        "class NoJax:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib'):\n"
        "            raise ImportError(name + ' is blocked')\n"
        "sys.meta_path.insert(0, NoJax())\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')]:\n"
        "    del sys.modules[k]\n"
        "import pytest\n"
        "rc = pytest.main(['--noconftest', '-p', 'no:cacheprovider', '-p', 'no:xdist',\n"
        "                  '-q', '--collect-only', '-m', 'cuda', *sys.argv[1:]])\n"
        "leaked = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "                ('jax', 'jaxlib', 'openwebrx_tpu'))\n"
        "print('RC', int(rc))\n"
        "print('LEAKED', leaked)\n")
    proc = subprocess.run([sys.executable, "-c", script, *(f"tests/{n}" for n in CARRYING)],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert "RC 0" in proc.stdout and "LEAKED []" in proc.stdout, proc.stdout + proc.stderr
    counts = re.search(r"(\d+)/(\d+) tests collected \((\d+) deselected\)", proc.stdout)
    assert counts, proc.stdout
    on_card, total, on_cpu = map(int, counts.groups())
    # every carried case once on the card and once on the CPU
    assert on_card == on_cpu and on_card + on_cpu == total, proc.stdout
    assert on_card >= sum(len(carried_cases(name)) for name in CARRIED), proc.stdout
