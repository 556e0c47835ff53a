"""Block descriptors: the GRC YAML schemas as first-class metadata.

The reference ships a GRC descriptor per block (grc/lora_*.block.yml) —
parameter ids, labels, dtypes, defaults, enum options, and port lists —
which GNU Radio Companion uses to render the block and generate the
``make`` call.  This module carries the SAME schemas programmatically so a
graph-composition UI, a config validator, or a flowgraph translator can
enumerate every block surface without parsing the reference YAML.  Values
are transcribed from grc/lora_{mod,encode,demod,pyramid_demod,weak_demod,
decode}.block.yml and cross-checked in tests/test_blocks_meta.py.  Twin
of gr_lora_tpu/blocks_meta.py; ``factory`` names a callable of
gr_lora_tpu_torch.blocks.
"""

from __future__ import annotations

import dataclasses

from .config import PeakSearch


@dataclasses.dataclass(frozen=True)
class Param:
    id: str
    label: str
    dtype: str                    # int | bool | float | enum
    default: object
    options: tuple = ()           # enum values
    option_labels: tuple = ()


@dataclasses.dataclass(frozen=True)
class Port:
    domain: str                   # stream | message
    id: str = ""
    dtype: str = ""


@dataclasses.dataclass(frozen=True)
class BlockMeta:
    id: str
    label: str
    category: str
    parameters: tuple
    inputs: tuple
    outputs: tuple
    factory: str                  # gr_lora_tpu_torch.blocks callable name

    def defaults(self) -> dict:
        return {p.id: p.default for p in self.parameters}


def _codec_params(with_payload_len: bool):
    ps = [Param("spreading_factor", "Spreading Factor", "int", 8),
          Param("header", "Header", "bool", True)]
    if with_payload_len:
        ps.append(Param("payload_len", "Payload Length", "int", 4))
    ps += [Param("code_rate", "Code Rate", "int", 1),
           Param("crc", "CRC", "bool", True),
           Param("low_data_rate", "Low Data Rate", "bool", False)]
    return ps


# grc/lora_mod.block.yml
MOD = BlockMeta(
    "lora_mod", "LoRa Modulator", "[lora]",
    (Param("spreading_factor", "Spreading Factor", "int", 8),
     Param("sync_word", "Sync Word", "int", 0x12)),
    (Port("message", "in"),),
    (Port("stream", dtype="complex"),),
    "mod")

# grc/lora_encode.block.yml (note the TX-side defaults differ from RX:
# code_rate 4, crc/header off)
ENCODE = BlockMeta(
    "lora_encode", "LoRa Encoder", "[lora]",
    (Param("spreading_factor", "Spreading Factor", "int", 8),
     Param("code_rate", "Code Rate / # Parity Bits", "int", 4),
     Param("crc", "CRC", "bool", False),
     Param("low_data_rate", "Low Data Rate", "bool", False),
     Param("header", "Explicit Header", "bool", False)),
    (Port("message", "in"),),
    (Port("message", "out"),),
    "encode")

# grc/lora_decode.block.yml
DECODE = BlockMeta(
    "lora_decode", "LoRa Decoder", "[lora]",
    tuple(_codec_params(with_payload_len=True)),
    (Port("message", "in"),),
    (Port("message", "out"), Port("message", "header")),
    "decode")

# grc/lora_demod.block.yml:7-52
DEMOD = BlockMeta(
    "lora_demod", "LoRa Demodulator", "[lora]",
    tuple(_codec_params(with_payload_len=True)) + (
        Param("beta", "FFT Window Beta", "float", 25.0),
        Param("fft_factor", "FFT Size Factor", "int", 10),
        Param("peak_search_algorithm", "Peak Search Algorithm", "enum",
              int(PeakSearch.ABS), (0, 1, 2), ("ABS", "PHASE", "B")),
        Param("peak_search_phase_k", "Peak Search PHASE K", "int", 4),
        Param("fs_bw_ratio", "Samp-BW ratio", "float", 2.0)),
    (Port("stream", dtype="complex"), Port("message", "header")),
    (Port("message", "out"),),
    "demod")

# grc/lora_pyramid_demod.block.yml:7-33
PYRAMID_DEMOD = BlockMeta(
    "lora_pyramid_demod", "Pyramid Demodulator", "[lora]",
    (Param("spreading_factor", "Spreading Factor", "int", 8),
     Param("low_data_rate", "Low Data Rate", "bool", False),
     Param("beta", "FFT Window Beta", "float", 25.0),
     Param("fft_factor", "FFT Size Factor", "int", 2),
     Param("threshold", "Peak Height Threshold", "float", 0.005),
     Param("fs_bw_ratio", "Samp-BW ratio", "float", 8.0)),
    (Port("stream", dtype="complex"), Port("message", "header")),
    (Port("message", "out"),),
    "pyramid_demod")

# grc/lora_weak_demod.block.yml:10-59
WEAK_DEMOD = BlockMeta(
    "lora_weak_demod", "Weak LoRa Demodulator", "[lora]",
    tuple(_codec_params(with_payload_len=True)) + (
        Param("sym_num", "Number of Symbols", "int", 10),
        Param("beta", "FFT Window Beta", "float", 25.0),
        Param("fft_factor", "FFT Size Factor", "int", 8),
        Param("peak_search_algorithm", "Peak Search Algorithm", "enum",
              int(PeakSearch.ABS), (0, 1, 2), ("ABS", "PHASE", "B")),
        Param("peak_search_phase_k", "Peak Search PHASE K", "int", 4),
        Param("fs_bw_ratio", "Samp-BW ratio", "float", 2.0)),
    (Port("stream", dtype="complex"),),
    (Port("message", "out"),),
    "weak_demod")

ALL_BLOCKS = (MOD, ENCODE, DECODE, DEMOD, PYRAMID_DEMOD, WEAK_DEMOD)


def get(block_id: str) -> BlockMeta:
    for b in ALL_BLOCKS:
        if b.id == block_id:
            return b
    raise KeyError(block_id)
