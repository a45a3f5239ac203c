"""Rig control: mirror the web receiver's tuning onto a physical transceiver.

Drives a hamlib ``rigctl`` subprocess in stdin-command mode: whenever a
client retunes or changes demodulator, the dial frequency (center +
offset) and matching rig modulation are pushed to the radio. The hamlib
model catalogue is exposed for the settings form so the rig is selectable
by name.

Reference: ``owrx/rigcontrol.py:14-395`` — same external tool and wire
commands (``F <hz>`` / ``M <mode> 0`` / ``T 0|1``); the model IDs are
hamlib's public rig list constants (``rigctl -l``). Our design differs:
a process-wide singleton fed explicitly from the connection layer's
dspcontrol path (we have no per-connection PropertyStack), a
manufacturer-grouped catalogue, and a daemon drain thread.
"""

from __future__ import annotations

import logging
import os
import select
import subprocess
import threading

logger = logging.getLogger(__name__)

# hamlib rig model IDs (public constants from hamlib's riglist.h / `rigctl -l`),
# grouped by manufacturer. (id, model) pairs; the settings form shows
# "<manufacturer> <model>" sorted by label.
RIG_CATALOG: dict[str, tuple[tuple[int, str], ...]] = {
    "Hamlib": ((2, "NET rigctl"), (4, "FLRig"), (5, "TRXManager 5.7.630+")),
    "ADAT": ((29001, "ADT-200A"),),
    "AE9RB": ((25016, "Si570 Peaberry V1"), (25017, "Si570 Peaberry V2")),
    "Alinco": ((17001, "DX-77"), (17002, "DX-SR8")),
    "AmQRP": ((25006, "DDS-60"),),
    "AMSAT-UK": ((25013, "FUNcube Dongle"), (25018, "FUNcube Dongle Pro+")),
    "ANAN": ((2048, "Thetis"),),
    "AOR": (
        (5001, "AR8200"), (5002, "AR8000"), (5003, "AR7030"), (5004, "AR5000"),
        (5005, "AR3030"), (5006, "AR3000A"), (5008, "AR2700"), (5013, "AR8600"),
        (5014, "AR5000A"), (5015, "AR7030 Plus"), (5016, "SR2200"),
    ),
    "Barrett": ((32001, "2050"), (32002, "950")),
    "Dorji": ((31001, "DRA818V"), (31002, "DRA818U")),
    "Drake": ((9002, "R-8A"), (9003, "R-8B")),
    "DttSP": ((23003, "IPC"), (23004, "UDP")),
    "ELAD": ((33001, "FDM-DUO"),),
    "Elecraft": (
        (2021, "K2"), (2029, "K3"), (2038, "XG3"), (2043, "K3S"),
        (2044, "KX2"), (2045, "KX3"), (2047, "K4"),
    ),
    "Elektor": ((25001, "3/04"), (25007, "SDR-USB")),
    "FiFi": ((25012, "FiFi-SDR"),),
    "FlexRadio": ((2036, "6xxx"), (2048, "PowerSDR"), (23001, "SDR-1000")),
    "Funkamateur": ((25015, "FA-SDR"),),
    "Hilberling": ((2046, "PT-8000A"),),
    "HobbyPCB": ((25019, "RS-HFIQ"),),
    "Icom": (
        (3002, "IC-1275"), (3003, "IC-271"), (3004, "IC-275"), (3006, "IC-471"),
        (3007, "IC-475"), (3008, "IC-575"), (3009, "IC-706"), (3010, "IC-706MkII"),
        (3011, "IC-706MkIIG"), (3012, "IC-707"), (3013, "IC-718"), (3014, "IC-725"),
        (3015, "IC-726"), (3016, "IC-728"), (3017, "IC-729"), (3019, "IC-735"),
        (3020, "IC-736"), (3021, "IC-737"), (3022, "IC-738"), (3023, "IC-746"),
        (3024, "IC-751"), (3026, "IC-756"), (3027, "IC-756PRO"), (3028, "IC-761"),
        (3029, "IC-765"), (3030, "IC-775"), (3031, "IC-781"), (3032, "IC-820H"),
        (3034, "IC-821H"), (3035, "IC-970"), (3036, "IC-R10"), (3037, "IC-R71"),
        (3038, "IC-R72"), (3039, "IC-R75"), (3040, "IC-R7000"), (3041, "IC-R7100"),
        (3042, "IC-R8500"), (3043, "IC-R9000"), (3044, "IC-910"), (3045, "IC-78"),
        (3046, "IC-746PRO"), (3047, "IC-756PROII"), (3051, "Omni VI Plus"),
        (3054, "ID-1"), (3055, "IC-703"), (3056, "IC-7800"), (3057, "IC-756PROIII"),
        (3058, "IC-R20"), (3060, "IC-7000"), (3061, "IC-7200"), (3062, "IC-7700"),
        (3063, "IC-7600"), (3065, "IC-92D"), (3066, "IC-R9500"), (3067, "IC-7410"),
        (3068, "IC-9100"), (3069, "IC-RX7"), (3070, "IC-7100"), (3071, "ID-5100"),
        (3072, "IC-2730"), (3073, "IC-7300"), (3075, "IC-785x"), (3077, "IC-R6"),
        (3078, "IC-7610"), (3079, "IC-R8600"), (3080, "IC-R30"), (3081, "IC-9700"),
        (3082, "ID-4100"), (3083, "ID-31"), (3084, "ID-51"), (3085, "IC-705"),
        (4001, "IC-PCR1000"), (4002, "IC-PCR100"), (4003, "IC-PCR1500"),
        (4004, "IC-PCR2500"), (30001, "IC-M700PRO"), (30002, "IC-M802"),
        (30003, "IC-M710"), (30004, "IC-M803"),
    ),
    "JRC": ((6005, "NRD-525"), (6006, "NRD-535D"), (6007, "NRD-545 DSP")),
    "Kachina": ((18001, "505DSP"),),
    "Kenwood": (
        (2001, "TS-50S"), (2002, "TS-440S"), (2003, "TS-450S"), (2004, "TS-570D"),
        (2005, "TS-690S"), (2006, "TS-711"), (2007, "TS-790"), (2008, "TS-811"),
        (2009, "TS-850"), (2010, "TS-870S"), (2011, "TS-940S"), (2012, "TS-950S"),
        (2013, "TS-950SDX"), (2014, "TS-2000"), (2015, "R-5000"), (2016, "TS-570S"),
        (2017, "TH-D7A"), (2019, "TH-F6A"), (2020, "TH-F7E"), (2022, "TS-930"),
        (2023, "TH-G71"), (2024, "TS-680S"), (2025, "TS-140S"), (2026, "TM-D700"),
        (2027, "TM-V7"), (2028, "TS-480"), (2030, "TRC-80"), (2031, "TS-590S"),
        (2033, "TH-D72A"), (2034, "TM-D710(G)"), (2037, "TS-590SG"),
        (2039, "TS-990S"), (2041, "TS-890S"), (2042, "TH-D74"),
    ),
    "KTH-SDR": ((25011, "Si570 PIC-USB"),),
    "Lowe": ((10004, "HF-235"),),
    "Malachite": ((2049, "DSP"),),
    "Microtelecom": ((3074, "Perseus"),),
    "mRS": ((25008, "miniVNA"),),
    "N2ADR": ((25014, "HiQSDR"),),
    "OpenHPSDR": ((2040, "PiHPSDR"),),
    "Optoelectronics": ((3052, "OptoScan535"), (3053, "OptoScan456")),
    "Philips/Simoco": ((28001, "PRM8060"),),
    "Racal": ((11003, "RA6790/GM"), (11005, "RA3702")),
    "RadioShack": ((8004, "PRO-2052"),),
    "RFT": ((24001, "EKD-500"),),
    "Rohde & Schwarz": ((27001, "ESMC"), (27002, "EB200"), (27003, "XK2100")),
    "SAT-Schneider": ((25002, "DRT1"),),
    "SigFox": ((2032, "Transfox"),),
    "Skanti": ((14002, "TRP8000"), (14004, "TRP8255SR")),
    "SoftRock": ((25009, "Si570 AVR-USB"),),
    "TAPR": ((22001, "DSP-10"),),
    "Ten-Tec": (
        (3064, "Delta II"), (16001, "TT-550"), (16002, "TT-538 Jupiter"),
        (16003, "RX-320"), (16004, "RX-340"), (16005, "RX-350"),
        (16007, "TT-516 Argonaut V"), (16008, "TT-565 Orion"),
        (16009, "TT-585 Paragon"), (16011, "TT-588 Omni VII"),
        (16012, "RX-331"), (16013, "TT-599 Eagle"),
    ),
    "Uniden": (
        (8001, "BC780xlt"), (8002, "BC245xlt"), (8003, "BC895xlt"),
        (8006, "BC250D"), (8010, "BCD-396T"), (8011, "BCD-996T"), (8012, "BC898T"),
    ),
    "Vertex Standard": ((1033, "VX-1700"),),
    "Video4Linux": ((26001, "SW/FM Radio"), (26002, "v2 SW/FM Radio")),
    "Watkins-Johnson": ((12004, "WJ-8888"),),
    "Winradio": (
        (15001, "WR-1000"), (15002, "WR-1500"), (15003, "WR-1550"),
        (15004, "WR-3100"), (15005, "WR-3150"), (15006, "WR-3500"),
        (15007, "WR-3700"), (15009, "WR-G313"),
    ),
    "Xiegu": ((3076, "X108G"),),
    "Yaesu": (
        (1001, "FT-847"), (1003, "FT-1000D"), (1004, "FT-1000MP Mark-V"),
        (1005, "FT-747GX"), (1006, "FT-757GX"), (1007, "FT-757GXII"),
        (1009, "FT-767GX"), (1010, "FT-736R"), (1011, "FT-840"), (1013, "FT-900"),
        (1014, "FT-920"), (1015, "FT-890"), (1016, "FT-990"), (1017, "FRG-100"),
        (1018, "FRG-9600"), (1019, "FRG-8800"), (1020, "FT-817"), (1021, "FT-100"),
        (1022, "FT-857"), (1023, "FT-897"), (1024, "FT-1000MP"),
        (1025, "FT-1000MP Mark-V Field"), (1026, "VR-5000"), (1027, "FT-450"),
        (1028, "FT-950"), (1029, "FT-2000"), (1030, "FTDX-9000"), (1031, "FT-980"),
        (1032, "FTDX-5000"), (1034, "FTDX-1200"), (1035, "FT-991"),
        (1036, "FT-891"), (1037, "FTDX-3000"), (1038, "FT-847UNI"),
        (1039, "FT-600"), (1040, "FTDX-101D"), (1041, "FT-818"),
        (1042, "FTDX-10"), (1043, "FT-897D"), (1044, "FTDX-101MP"),
    ),
}

# receiver mode id -> rigctl modulation token (hamlib names). CW maps to
# CWR because the web receiver tunes the carrier, like the reference.
RIG_MODES = {
    "nfm": "FM", "wfm": "WFM", "am": "AM", "sam": "SAM",
    "lsb": "LSB", "usb": "USB", "lsbd": "PKTLSB", "usbd": "PKTUSB",
    "cw": "CWR",
}


def rig_models() -> list[dict]:
    """Catalogue for the settings form: [{id, label}] sorted by label."""
    out = [
        {"id": mid, "label": f"{maker} {model}"}
        for maker, models in RIG_CATALOG.items()
        for mid, model in models
    ]
    out.sort(key=lambda m: m["label"].lower())
    return out


class RigControl:
    """Singleton rigctl bridge fed from the connection layer.

    ``retune(center, offset)`` and ``set_mode(mod)`` are cheap no-ops when
    disabled; ``apply_config()`` re-reads the config so the settings UI can
    toggle rig control live.
    """

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def shared(cls) -> "RigControl":
        with cls._lock:
            if cls._instance is None:
                cls._instance = RigControl()
            return cls._instance

    def __init__(self):
        self.proc: subprocess.Popen | None = None
        self.thread: threading.Thread | None = None
        self._plock = threading.Lock()
        self._mod: str | None = None
        self._freq: int | None = None
        self.enabled = False
        self.apply_config()

    # -- lifecycle ---------------------------------------------------------

    def apply_config(self):
        """(Re)read rig_* config keys; start or stop the bridge to match."""
        from openwebrx_tpu_torch.core.config import Config
        config = Config.get()
        want = bool(config.get("rig_enabled"))
        if want and self.proc is None:
            self._start(config)
        elif not want and self.proc is not None:
            self.stop()
        self.enabled = want and self.proc is not None

    def _start(self, config):
        model = int(config.get("rig_model", 2))
        device = str(config.get("rig_device", "127.0.0.1:4533"))
        address = int(config.get("rig_address", 0) or 0)
        cmd = ["rigctl", "-m", str(model), "-r", device]
        if 0 < address < 256:  # CI-V / bus address for multi-drop rigs
            cmd += ["-c", str(address)]
        cmd.append("-")
        try:
            self.proc = subprocess.Popen(
                cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT)
        except FileNotFoundError:
            logger.warning("rigctl not available; rig control disabled")
            self.proc = None
            return
        os.set_blocking(self.proc.stdout.fileno(), False)
        self.thread = threading.Thread(target=self._drain, daemon=True,
                                       name="rigctl-drain")
        self.thread.start()
        self._mod = None
        self._freq = None
        logger.info("rig control started: %s", " ".join(cmd))

    def _drain(self):
        """Log rigctl responses so protocol errors are visible."""
        proc = self.proc
        while proc is not None and proc.poll() is None:
            try:
                readable, _, _ = select.select([proc.stdout], [], [], 1.0)
                for pipe in readable:
                    data = pipe.read()
                    if data:
                        logger.debug("rigctl: %s",
                                     data.decode(errors="replace").strip())
            except (OSError, ValueError):
                break
        logger.debug("rigctl exited (%s)", proc.poll() if proc else None)

    def stop(self):
        # swap + close under _plock: _command may be mid-write in another
        # thread, and write/flush on a just-closed pipe raises ValueError
        # (not in _command's except clause) — ADVICE r3
        with self._plock:
            proc, self.proc = self.proc, None
            if proc is None:
                return
            try:
                proc.stdin.close()
            except (OSError, ValueError):
                pass
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(3)
            except subprocess.TimeoutExpired:
                proc.kill()
        if self.thread is not None:
            self.thread.join(timeout=3)
            self.thread = None
        self.enabled = False

    # -- commands ----------------------------------------------------------

    def _command(self, cmd: str) -> bool:
        with self._plock:
            proc = self.proc
            if proc is None:
                return False
            if proc.poll() is not None:
                self.proc = None
                self.enabled = False
                return False
            try:
                proc.stdin.write((cmd + "\n").encode())
                proc.stdin.flush()
                return True
            except (BrokenPipeError, OSError):
                logger.warning("rigctl pipe broken; rig control disabled")
                self.proc = None
                self.enabled = False
                return False

    def retune(self, center_hz: float, offset_hz: float) -> bool:
        """Push the dial frequency. Dedupes repeats (drag retunes spam)."""
        if not self.enabled:
            return False
        freq = int(center_hz + offset_hz)
        if freq == self._freq:
            return True
        self._freq = freq
        return self._command(f"F {freq}")

    def set_mode(self, mod: str) -> bool:
        if not self.enabled or mod == self._mod:
            return False
        rig_mode = RIG_MODES.get(mod)
        if rig_mode is None:
            return False
        self._mod = mod
        return self._command(f"M {rig_mode} 0")

    def set_ptt(self, active: bool) -> bool:
        return self.enabled and self._command(f"T {1 if active else 0}")
