"""SDR device descriptions: per-type driver commands + settings metadata.

Reference: the 28 ``{Type}Source``/``{Type}DeviceDescription`` pairs under
``owrx/source/`` (SURVEY §2.4).  Connector-family devices all speak the
owrx_connector TCP protocol (float IQ port + prop:value control port); the
description supplies the command template, the defaults, and which
properties are live-tunable over the control socket vs require restart.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class DeviceDescription:
    """Settings metadata for one device type (reference
    SdrDeviceDescription.getInputs, owrx/source/__init__.py:640-835)."""

    type: str
    name: str
    command: str | None            # driver template; None = attach-only
    requirement: str               # feature gate
    gain_stages: Sequence[str] = ()
    sample_rates: Sequence[int] = ()
    supports_ppm: bool = True
    supports_bias_tee: bool = False
    supports_direct_sampling: bool = False
    extra_keys: Sequence[str] = ()

    def inputs(self) -> list[dict]:
        """Settings-form schema (key/type/label), consumed by the settings
        API/UI."""
        out = [
            {"key": "name", "type": "str", "label": "Device name"},
            {"key": "device", "type": "str", "label": "Device selector"},
            {"key": "rf_gain", "type": "gain", "label": "RF gain",
             "stages": list(self.gain_stages)},
            {"key": "samp_rate", "type": "int", "label": "Sample rate",
             "choices": list(self.sample_rates)},
            {"key": "center_freq", "type": "int", "label": "Center frequency"},
        ]
        if self.supports_ppm:
            out.append({"key": "ppm", "type": "num", "label": "Frequency correction (ppm)"})
        if self.supports_bias_tee:
            out.append({"key": "bias_tee", "type": "bool", "label": "Bias tee"})
        if self.supports_direct_sampling:
            out.append({"key": "direct_sampling", "type": "int",
                        "label": "Direct sampling (0/1/2)"})
        out += [{"key": k, "type": "str", "label": k} for k in self.extra_keys]
        return out


_RTL_RATES = [250000, 1024000, 1536000, 1792000, 1920000, 2048000, 2400000,
              2560000, 2880000, 3200000]
_SOAPY = "soapy_connector -p {port} -c {control_port} -s {samp_rate} " \
         "-f {center_freq} -g {rf_gain} -P {ppm} -d "

DEVICE_TYPES: dict[str, DeviceDescription] = {
    "rtl_sdr": DeviceDescription(
        "rtl_sdr", "RTL-SDR (USB)",
        "rtl_connector -p {port} -c {control_port} -s {samp_rate} "
        "-f {center_freq} -g {rf_gain} -P {ppm} -d {device}",
        "rtl_sdr", sample_rates=_RTL_RATES, supports_bias_tee=True,
        supports_direct_sampling=True),
    "rtl_tcp": DeviceDescription(
        "rtl_tcp", "RTL-SDR (rtl_tcp)",
        "rtl_tcp_connector -p {port} -c {control_port} -s {samp_rate} "
        "-f {center_freq} -g {rf_gain} -P {ppm} -r {device}",
        "rtl_tcp", sample_rates=_RTL_RATES),
    "sdrplay": DeviceDescription(
        "sdrplay", "SDRplay (RSP)", _SOAPY + "sdrplay", "soapy_connector",
        gain_stages=["RFGR", "IFGR"], extra_keys=["antenna"]),
    "airspy": DeviceDescription(
        "airspy", "Airspy R2/Mini", _SOAPY + "airspy", "soapy_connector",
        gain_stages=["LNA", "MIX", "VGA"], supports_bias_tee=True),
    "airspyhf": DeviceDescription(
        "airspyhf", "Airspy HF+", _SOAPY + "airspyhf", "soapy_connector"),
    "hackrf": DeviceDescription(
        "hackrf", "HackRF", _SOAPY + "hackrf", "soapy_connector",
        gain_stages=["LNA", "VGA", "AMP"], supports_bias_tee=True),
    "lime_sdr": DeviceDescription(
        "lime_sdr", "LimeSDR", _SOAPY + "lime", "soapy_connector",
        extra_keys=["antenna"]),
    "pluto_sdr": DeviceDescription(
        "pluto_sdr", "PlutoSDR", _SOAPY + "plutosdr", "soapy_connector"),
    "uhd": DeviceDescription(
        "uhd", "Ettus USRP", _SOAPY + "uhd", "soapy_connector",
        extra_keys=["antenna", "subdevice"]),
    "radioberry": DeviceDescription(
        "radioberry", "RadioBerry", _SOAPY + "radioberry", "soapy_connector"),
    "fcdpp": DeviceDescription(
        "fcdpp", "FunCube Dongle Pro+", _SOAPY + "fcdpp", "soapy_connector"),
    "bladerf": DeviceDescription(
        "bladerf", "BladeRF", _SOAPY + "bladerf", "soapy_connector",
        supports_bias_tee=True),
    "rtl_sdr_soapy": DeviceDescription(
        "rtl_sdr_soapy", "RTL-SDR (SoapySDR)", _SOAPY + "rtlsdr",
        "soapy_connector", sample_rates=_RTL_RATES,
        supports_direct_sampling=True, supports_bias_tee=True),
    "soapy_remote": DeviceDescription(
        "soapy_remote", "SoapyRemote", _SOAPY + "remote",
        "soapy_connector", extra_keys=["remote"]),
    "hydrasdr": DeviceDescription(
        "hydrasdr", "HydraSDR", _SOAPY + "hydrasdr", "soapy_connector"),
    "sddc_soapy": DeviceDescription(
        "sddc_soapy", "SDDC (RX666/RX888, SoapySDR)", _SOAPY + "SDDC",
        "soapy_connector",
        sample_rates=[2000000, 4000000, 8000000, 16000000, 32000000]),
    "sddc": DeviceDescription(
        "sddc", "SDDC (RX666/RX888)",
        "sddc_connector -p {port} -c {control_port} -s {samp_rate} "
        "-f {center_freq} -g {rf_gain}", "sddc_connector"),
    "hpsdr": DeviceDescription(
        "hpsdr", "HPSDR / Hermes-Lite",
        "hpsdr_connector -p {port} -c {control_port} -s {samp_rate} "
        "-f {center_freq} -g {rf_gain} -r {device}", "hpsdr_connector"),
    "runds": DeviceDescription(
        "runds", "R&S (RunDS)",
        "runds_connector -p {port} -c {control_port} -s {samp_rate} "
        "-f {center_freq} -r {device}", "runds_connector"),
    "afedri": DeviceDescription(
        "afedri", "Afedri", _SOAPY + "afedri", "soapy_connector"),
    "mirics": DeviceDescription(
        "mirics", "Mirics MSi001", _SOAPY + "mirisdr", "soapy_connector"),
    # direct/exec family: driver writes IQ to stdout, restart on retune
    # (reference owrx/source/{fifi_sdr,perseussdr}.py via DirectSource)
    "fifi_sdr": DeviceDescription(
        "fifi_sdr", "FiFi-SDR",
        "arecord -D {device} -f S16_LE -r {samp_rate} -c 2 -t raw",
        "fifi_sdr", sample_rates=[48000, 96000, 192000],
        supports_ppm=False, extra_keys=["device"]),
    "perseussdr": DeviceDescription(
        "perseussdr", "Microtelecom Perseus",
        "perseustest -p -d -1 -a -t 0 -o - -s {samp_rate} -f {center_freq} "
        "-u {rf_gain}",
        "perseussdr", sample_rates=[95000, 125000, 250000, 500000, 1000000,
                                    2000000], supports_ppm=False),
    # attach-only / file types
    "file": DeviceDescription("file", "IQ file replay", None, "file_source",
                              supports_ppm=False,
                              extra_keys=["file_path", "file_format", "throttle"]),
    "signal": DeviceDescription("signal", "Synthetic signals", None,
                                "file_source", supports_ppm=False,
                                extra_keys=["signals", "noise"]),
}


def get_description(device_type: str) -> DeviceDescription | None:
    return DEVICE_TYPES.get(device_type)


def build_command(device_type: str, props) -> str | None:
    desc = DEVICE_TYPES.get(device_type)
    if desc is None or desc.command is None:
        return None
    keys = ("port", "control_port", "samp_rate", "center_freq", "rf_gain",
            "ppm", "device")
    values = {k: props.get(k, "") for k in keys}
    values.setdefault("ppm", 0)
    return desc.command.format(**values)
