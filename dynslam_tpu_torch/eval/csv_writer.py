"""CSV writer matching the reference's `CsvWriter` semantics
(Evaluation/CsvWriter.h:25-50): writes the header from the first record,
then one data line per record; flushes on every write so partial runs
still produce usable CSVs. A copy of ``dynslam_tpu/eval/csv_writer.py``.
"""

from __future__ import annotations

import os
from typing import Optional, Protocol


class ICsvSerializable(Protocol):
    def get_header(self) -> str: ...

    def get_data(self) -> str: ...


class CsvWriter:
    def __init__(self, output_path: str):
        self.output_path = output_path
        parent = os.path.dirname(output_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._file: Optional[object] = None
        self._wrote_header = False

    def write(self, record: ICsvSerializable) -> None:
        if self._file is None:
            self._file = open(self.output_path, "w")
        if not self._wrote_header:
            self._file.write(record.get_header() + "\n")
            self._wrote_header = True
        self._file.write(record.get_data() + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
