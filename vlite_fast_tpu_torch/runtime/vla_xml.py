"""VLA Executor XML document parsing.

The messenger's input side (SURVEY.md section 2a #12-15): the VLA Executor
multicasts three XML document types which the reference parses with an
expat stack (src/executor.c:160-455 ObservationDocument/AntPropDocument/
SubarrayDocument, src/alert.c:84-160 AlertDocument, src/vlite_xml.c).  Here
a single xml.etree pass fills typed dataclasses; field names mirror the
reference structs (src/executor.h:63-111) so obsinfo archives round-trip.

The port's copy of vlite_fast_tpu/runtime/vla_xml.py, on the port's
ObservationDocument.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict

from vlite_fast_tpu_torch.runtime.control import ObservationDocument

VLA_ANTENNA_COUNT = 28


@dataclass
class AntennaProperties:
    """One antenna row (ref VLAAntenna, src/vlaant.h:7-13)."""

    number: int = 0
    X: float = 0.0          # meters, relative to VLA center
    Y: float = 0.0
    Z: float = 0.0
    axis_offset: float = 0.0


@dataclass
class EOP:
    """Earth-orientation parameters (ref src/eop.h:7-16)."""

    mjd: int = 0
    tai_utc: float = 0.0
    ut1_utc: float = 0.0
    x_pole: float = 0.0
    y_pole: float = 0.0


@dataclass
class AntPropDocument:
    creation_time: float = 0.0      # UT MJD
    dataset_id: str = ""
    array_configuration: str = ""
    antennas: Dict[int, AntennaProperties] = field(default_factory=dict)
    eops: list = field(default_factory=list)


@dataclass
class AlertDocument:
    """Device alert (ref AlertDocument, src/alert.c:91-160)."""

    location: str = ""
    timestamp: float = 0.0
    device_name: str = ""
    monitor_name: str = ""
    alert_state: int = 0

    @property
    def vla_ant(self) -> int:
        m = re.match(r"ea(\d\d)-", self.location)
        return int(m.group(1)) if m else 0

    @property
    def location_suffix(self) -> str:
        m = re.match(r"ea\d\d-(.*)", self.location)
        return m.group(1) if m else ""


def _strip_ns(tag: str) -> str:
    return tag.split("}")[-1].split(":")[-1]


def _text(elem) -> str:
    return (elem.text or "").strip()


def parse_obs_document(xml_text: str) -> ObservationDocument:
    """<Observation datasetId=... configId=... startTime=...> with child
    elements name/ra/dec/.../scanNo/subscanNo/intent
    (ref src/executor.c:172-396)."""
    root = ET.fromstring(xml_text)
    if _strip_ns(root.tag) != "Observation":
        raise ValueError(f"not an Observation document: {root.tag}")
    od = ObservationDocument(
        datasetId=root.get("datasetId", ""),
        start_time=float(root.get("startTime", 0.0)),
    )
    intent = ""
    for child in root.iter():
        tag = _strip_ns(child.tag)
        if tag == "name":
            od.name = _text(child)
        elif tag == "ra":
            od.ra = float(_text(child) or 0)
        elif tag == "dec":
            od.dec = float(_text(child) or 0)
        elif tag == "scanNo":
            od.scan_no = int(_text(child) or 0)
        elif tag == "subscanNo":
            od.subscan_no = int(_text(child) or 0)
        elif tag == "intent":
            intent = _text(child)
    # FINISH intent ends the scheduling block (ref messenger.c:263-268)
    if "FINISH" in intent.upper() or od.name.upper() == "FINISH":
        od.finishes = True
    return od


def parse_antprop_document(xml_text: str) -> AntPropDocument:
    """<AntennaPropertyTable creation=... configuration=...> with
    <AntennaProperties name="ea05"><X>..</X>... and <eopday> children
    (ref src/executor.c:194-446)."""
    root = ET.fromstring(xml_text)
    if _strip_ns(root.tag) != "AntennaPropertyTable":
        raise ValueError(f"not an AntennaPropertyTable: {root.tag}")
    doc = AntPropDocument(
        creation_time=float(root.get("creation", 0.0)),
        dataset_id=root.get("datasetID", root.get("datasetId", "")),
        array_configuration=root.get("configuration", ""),
    )
    for child in root.iter():
        tag = _strip_ns(child.tag)
        if tag == "AntennaProperties":
            name = child.get("name", "")
            m = re.match(r"ea(\d+)", name)
            if not m:
                continue
            num = int(m.group(1))
            ant = AntennaProperties(number=num)
            for sub in child:
                stag = _strip_ns(sub.tag)
                if stag == "X":
                    ant.X = float(_text(sub) or 0)
                elif stag == "Y":
                    ant.Y = float(_text(sub) or 0)
                elif stag == "Z":
                    ant.Z = float(_text(sub) or 0)
                elif stag == "axisOffset":
                    ant.axis_offset = float(_text(sub) or 0)
            doc.antennas[num] = ant
        elif tag == "eopday":
            eop = EOP()
            for sub in child:
                stag = _strip_ns(sub.tag)
                val = _text(sub)
                if stag == "epoch":
                    eop.mjd = int(float(val) + 0.5)
                elif stag == "tai_utc":
                    eop.tai_utc = float(val)
                elif stag == "ut1_utc":
                    eop.ut1_utc = float(val)
                elif stag == "x_pole":
                    eop.x_pole = float(val)
                elif stag == "y_pole":
                    eop.y_pole = float(val)
            doc.eops.append(eop)
    return doc


def parse_alert_document(xml_text: str) -> AlertDocument:
    """<EVLAMessage location="ea05-..." timestamp=...><device name=...>
    <monitor name=... alert=.../> (ref src/alert.c:84-160)."""
    root = ET.fromstring(xml_text)
    doc = AlertDocument(
        location=root.get("location", ""),
        timestamp=float(root.get("timestamp", 0.0)),
    )
    for child in root.iter():
        tag = _strip_ns(child.tag)
        if tag == "device":
            doc.device_name = child.get("name", doc.device_name)
        elif tag == "monitor":
            doc.monitor_name = child.get("name", doc.monitor_name)
            doc.alert_state = int(child.get("alert", doc.alert_state))
    return doc


def parse_scaninfo(xml_text: str):
    """Dispatch on the root element like parseScanInfoDocument
    (ref src/executor.c:453+). Returns one of the three document types."""
    root_tag = _strip_ns(ET.fromstring(xml_text).tag)
    if root_tag == "Observation":
        return parse_obs_document(xml_text)
    if root_tag == "AntennaPropertyTable":
        return parse_antprop_document(xml_text)
    if root_tag == "EVLAMessage":
        return parse_alert_document(xml_text)
    raise ValueError(f"unknown scaninfo document: {root_tag}")
