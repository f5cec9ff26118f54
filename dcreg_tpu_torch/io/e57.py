"""Minimal E57 (ASTM E2807) point-cloud reader/writer (counterpart of
``dcreg_tpu/io/e57.py``, numpy and struct only).

Covers the subset the reference's dataset-prep converter needs:

  * the physical layer: 1024-byte pages, each 1020 payload bytes + a
    CRC-32C checksum, with logical offsets that skip the checksums;
  * the E57 file header (signature block, XML offset/length);
  * one CompressedVector of cartesian (x, y, z[, intensity]) fields
    encoded with the bitPackCodec at Float(double)/Float(single)
    precision -- raw little-endian IEEE floats packed per stream in data
    packets, which is what scanners' "uncompressed" exports and pye57's
    writer produce;
  * index packets are skipped on read (sequential decode) and an empty
    index is written.

When ``pye57`` is importable ``read_e57`` prefers it (full-format
coverage); the numpy path covers the round trip and uncompressed
real-world files.
"""
from __future__ import annotations

import struct
import xml.etree.ElementTree as ET

import numpy as np

PAGE = 1024
PAYLOAD = 1020

_E57_NS = "http://www.astm.org/COMMIT/E57/2010-e57-v1.0"


# ---------------------------------------------------------------- CRC-32C
def _crc32c_table():
    poly = 0x82F63B78
    table = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if (c & 1) else (c >> 1)
        table[i] = c
    return table


_CRC_TABLE = _crc32c_table()


def crc32c_pages(pages: np.ndarray) -> np.ndarray:
    """CRC-32C of every row of a (n_pages, PAYLOAD) uint8 array at once.

    The CRC recurrence is sequential in the byte position but independent
    across pages, so iterating 1020 byte positions over a vector of page
    states is ~n_pages times faster than per-byte Python -- the difference
    between hours and seconds on multi-hundred-MB files."""
    pages = np.ascontiguousarray(pages, np.uint8)
    crc = np.full(pages.shape[0], 0xFFFFFFFF, np.uint32)
    tab = _CRC_TABLE
    for col in range(pages.shape[1]):
        crc = tab[(crc ^ pages[:, col]) & np.uint32(0xFF)] \
            ^ (crc >> np.uint8(8))
    return crc ^ np.uint32(0xFFFFFFFF)


def crc32c(data: bytes) -> int:
    return int(crc32c_pages(np.frombuffer(data, np.uint8)[None, :])[0])


# ------------------------------------------------------- physical <-> logical
def _to_physical(payload: bytes) -> bytes:
    """Split a logical byte stream into CRC'd 1024-byte pages."""
    n_pages = -(-len(payload) // PAYLOAD) if payload else 0
    buf = np.zeros(n_pages * PAYLOAD, np.uint8)
    buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    pages = buf.reshape(n_pages, PAYLOAD)
    crcs = crc32c_pages(pages)
    out = np.zeros((n_pages, PAGE), np.uint8)
    out[:, :PAYLOAD] = pages
    out[:, PAYLOAD:] = crcs.astype("<u4").view(np.uint8).reshape(n_pages, 4)
    return out.tobytes()


def _to_logical(raw: bytes) -> bytes:
    """Strip (and verify) page checksums."""
    if len(raw) % PAGE:
        raise ValueError("E57 file not page-aligned")
    arr = np.frombuffer(raw, np.uint8).reshape(-1, PAGE)
    stored = arr[:, PAYLOAD:].copy().view("<u4").ravel()
    computed = crc32c_pages(arr[:, :PAYLOAD])
    bad = np.nonzero(stored != computed)[0]
    if bad.size:
        raise ValueError(f"E57 page checksum mismatch at {int(bad[0]) * PAGE}")
    return arr[:, :PAYLOAD].tobytes()


def _phys_offset(logical: int) -> int:
    """Physical file offset of a logical offset."""
    return (logical // PAYLOAD) * PAGE + (logical % PAYLOAD)


# -------------------------------------------------------------------- write
def write_e57(path: str, xyz, intensity=None, guid="{dcreg-tpu-0000}"):
    """Write (N, 3) float64 cartesian points (+ optional intensity) as a
    single-scan E57 file (bitPackCodec doubles, one data packet stream
    chunked at <=64 KiB)."""
    xyz = np.asarray(xyz, np.float64)
    n = xyz.shape[0]
    fields = [("cartesianX", xyz[:, 0]), ("cartesianY", xyz[:, 1]),
              ("cartesianZ", xyz[:, 2])]
    if intensity is not None:
        fields.append(("intensity", np.asarray(intensity, np.float64)))

    # ---- binary section: data packets, <= 64 KiB each -------------------
    # section header (CompressedVectorSectionHeader, 32 bytes):
    #   sectionId=1, reserved[7], sectionLogicalLength, dataPhysicalOffset,
    #   indexPhysicalOffset -- offsets filled after layout
    max_per_packet = 2000   # points per packet (x nfields x 8 bytes)
    packets = []
    for start in range(0, max(n, 1), max_per_packet):
        cnt = min(max_per_packet, n - start) if n else 0
        streams = [v[start:start + cnt].tobytes() for _, v in fields]
        lengths = [len(s) for s in streams]
        body = b"".join(struct.pack("<H", ln) for ln in lengths) \
            + b"".join(streams)
        head = struct.pack("<BBH", 1, 0, 0)  # type=1 (data), flags, len-1
        pkt = head + struct.pack("<H", len(fields)) + body
        pad = (-len(pkt)) % 4
        pkt += b"\0" * pad
        pkt = pkt[:2] + struct.pack("<H", len(pkt) - 1) + pkt[4:]
        packets.append(pkt)
        if n == 0:
            break
    payload = b"".join(packets)
    section_header = struct.pack("<B7xQQQ", 1, 32 + len(payload), 0, 0)
    binary_logical = section_header + payload

    header_size = 48  # E57 file header is its own logical prefix
    bin_logical_start = header_size
    bin_phys_start = _phys_offset(bin_logical_start)

    # ---- XML ------------------------------------------------------------
    def F(name, vals):
        return (f'<{name} type="Float" precision="double" '
                f'minimum="{vals.min() if len(vals) else 0!r}" '
                f'maximum="{vals.max() if len(vals) else 0!r}"/>')

    proto = "".join(F(name, v) for name, v in fields)
    xml = (
        f'<?xml version="1.0" encoding="UTF-8"?>'
        f'<e57Root type="Structure" xmlns="{_E57_NS}">'
        f'<formatName type="String"><![CDATA[ASTM E57 3D Imaging Data File]]></formatName>'
        f'<guid type="String"><![CDATA[{guid}]]></guid>'
        f'<versionMajor type="Integer">1</versionMajor>'
        f'<versionMinor type="Integer">0</versionMinor>'
        f'<data3D type="Vector" allowHeterogeneousChildren="1">'
        f'<vectorChild type="Structure">'
        f'<guid type="String"><![CDATA[{guid}-scan0]]></guid>'
        f'<points type="CompressedVector" fileOffset="{bin_phys_start}" '
        f'recordCount="{n}">'
        f'<prototype type="Structure">{proto}</prototype>'
        f'<codecs type="Vector" allowHeterogeneousChildren="1"/>'
        f'</points></vectorChild></data3D></e57Root>'
    ).encode()

    xml_logical_start = bin_logical_start + len(binary_logical)
    xml_phys_start = _phys_offset(xml_logical_start)

    file_header = struct.pack(
        "<8sIIQQQQ",             # 48 bytes; pageSize is u64
        b"ASTM-E57", 1, 0,
        0,                       # physical file length (patched below)
        xml_phys_start, len(xml),
        PAGE)
    logical = file_header + binary_logical + xml
    physical = bytearray(_to_physical(logical))
    # patch physical length into the header (offset 16), re-CRC page 0
    struct.pack_into("<Q", physical, 16, len(physical))
    page0 = bytes(physical[:PAYLOAD])
    struct.pack_into("<I", physical, PAYLOAD, crc32c(page0))
    with open(path, "wb") as f:
        f.write(physical)


# --------------------------------------------------------------------- read
def read_e57(path: str):
    """Read an E57 file -> dict with "xyz" (N, 3) float64 and any extra
    float fields ("intensity", ...).  Prefers pye57 when available."""
    try:
        import pye57  # noqa: F401
        return _read_pye57(path)
    except ImportError:
        return _read_numpy(path)


def _read_pye57(path):
    import pye57
    f = pye57.E57(path)
    data = f.read_scan_raw(0)
    out = {"xyz": np.stack([data["cartesianX"], data["cartesianY"],
                            data["cartesianZ"]], axis=1)}
    if "intensity" in data:
        out["intensity"] = np.asarray(data["intensity"])
    return out


def _read_numpy(path):
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != b"ASTM-E57":
        raise ValueError("not an E57 file")
    logical = _to_logical(raw)
    (xml_phys, xml_len) = struct.unpack_from("<QQ", logical, 24)
    xml_logical = (xml_phys // PAGE) * PAYLOAD + (xml_phys % PAGE)
    xml = logical[xml_logical:xml_logical + xml_len]
    root = ET.fromstring(xml.decode())
    ns = {"e": _E57_NS}
    pts = root.find("e:data3D/e:vectorChild/e:points", ns)
    if pts is None:   # namespace-less writers
        pts = root.find("data3D/vectorChild/points")
        ns = None
    n = int(pts.attrib["recordCount"])
    bin_phys = int(pts.attrib["fileOffset"])
    proto = pts.find("e:prototype", ns) if ns else pts.find("prototype")
    names, dtypes = [], []
    for child in proto:
        tag = child.tag.split("}")[-1]
        names.append(tag)
        prec = child.attrib.get("precision", "double")
        dtypes.append(np.float32 if prec == "single" else np.float64)

    bin_logical = (bin_phys // PAGE) * PAYLOAD + (bin_phys % PAGE)
    sec_id, sec_len, _, _ = struct.unpack_from("<B7xQQQ"[:len("<B7xQQQ")],
                                               logical, bin_logical)
    if sec_id != 1:
        raise ValueError("expected CompressedVector binary section")
    off = bin_logical + 32
    end = bin_logical + sec_len
    cols = [[] for _ in names]
    while off < end:
        ptype, _flags, len_m1 = struct.unpack_from("<BBH", logical, off)
        plen = len_m1 + 1
        if ptype == 1:      # data packet
            (n_streams,) = struct.unpack_from("<H", logical, off + 4)
            lens = struct.unpack_from(f"<{n_streams}H", logical, off + 6)
            pos = off + 6 + 2 * n_streams
            for i in range(min(n_streams, len(names))):
                cols[i].append(np.frombuffer(
                    logical, dtype=dtypes[i], count=lens[i]
                    // np.dtype(dtypes[i]).itemsize, offset=pos))
                pos += lens[i]
        off += plen          # index (0) / empty (2) packets: skip
    arrays = {nm: (np.concatenate(c)[:n] if c else np.zeros(0))
              for nm, c in zip(names, cols)}
    out = {"xyz": np.stack([arrays.get("cartesianX", np.zeros(n)),
                            arrays.get("cartesianY", np.zeros(n)),
                            arrays.get("cartesianZ", np.zeros(n))], axis=1)}
    for nm, arr in arrays.items():
        if not nm.startswith("cartesian"):
            out[nm] = arr
    return out
