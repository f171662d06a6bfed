"""Core record types: Protein, KStats, KSettings.

Mirrors the reference protobuf schemas (reference pkg/kvstore/protein.proto,
kstats.proto, ksettings.proto) as plain dataclasses.  JSON field names match
the Go struct field names (with omitempty semantics) so that API responses
are shaped like the reference server's (api/server.go:125-132,
search.go:497-503).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class Protein:
    """One protein record (protein.proto:5-13)."""

    EntryId: str = ""
    Sequence: str = ""
    Length: int = 0
    Features: Dict[str, str] = field(default_factory=dict)

    def to_json_obj(self) -> dict:
        # Go protobuf-generated structs marshal with omitempty.
        out = {}
        if self.EntryId:
            out["EntryId"] = self.EntryId
        if self.Sequence:
            out["Sequence"] = self.Sequence
        if self.Length:
            out["Length"] = self.Length
        if self.Features:
            out["Features"] = self.Features
        return out


@dataclass
class KStats:
    """Database statistics stored under "db_stats" (kstats.proto:5-13)."""

    NumberOfProteins: int = 0
    NumberOfAA: int = 0
    NumberOfKmers: int = 0
    NumberOfKCombSets: int = 0
    Features: List[str] = field(default_factory=list)

    def to_json_obj(self) -> dict:
        out = {}
        if self.NumberOfProteins:
            out["NumberOfProteins"] = self.NumberOfProteins
        if self.NumberOfAA:
            out["NumberOfAA"] = self.NumberOfAA
        if self.NumberOfKmers:
            out["NumberOfKmers"] = self.NumberOfKmers
        if self.NumberOfKCombSets:
            out["NumberOfKCombSets"] = self.NumberOfKCombSets
        if self.Features:
            out["Features"] = self.Features
        return out

    @classmethod
    def from_json_obj(cls, obj: dict) -> "KStats":
        return cls(
            NumberOfProteins=obj.get("NumberOfProteins", 0),
            NumberOfAA=obj.get("NumberOfAA", 0),
            NumberOfKmers=obj.get("NumberOfKmers", 0),
            NumberOfKCombSets=obj.get("NumberOfKCombSets", 0),
            Features=list(obj.get("Features", [])),
        )


@dataclass
class KSettings:
    """Database settings stored under "db_settings" (ksettings.proto:5-15,
    written by the index pass, indexdb.go:170-198)."""

    Name: str = ""
    Port: int = 8321
    CreationDate: str = ""
    OriginalFile: str = ""
    DatabaseIndexed: bool = False
    IDsIndexed: bool = False
    NamesIndexed: bool = False

    def to_json_obj(self) -> dict:
        out = {}
        if self.Name:
            out["Name"] = self.Name
        if self.Port:
            out["Port"] = self.Port
        if self.CreationDate:
            out["CreationDate"] = self.CreationDate
        if self.OriginalFile:
            out["OriginalFile"] = self.OriginalFile
        if self.DatabaseIndexed:
            out["DatabaseIndexed"] = self.DatabaseIndexed
        if self.IDsIndexed:
            out["IDsIndexed"] = self.IDsIndexed
        if self.NamesIndexed:
            out["NamesIndexed"] = self.NamesIndexed
        return out

    @classmethod
    def from_json_obj(cls, obj: dict) -> "KSettings":
        return cls(
            Name=obj.get("Name", ""),
            Port=obj.get("Port", 8321),
            CreationDate=obj.get("CreationDate", ""),
            OriginalFile=obj.get("OriginalFile", ""),
            DatabaseIndexed=obj.get("DatabaseIndexed", False),
            IDsIndexed=obj.get("IDsIndexed", False),
            NamesIndexed=obj.get("NamesIndexed", False),
        )
