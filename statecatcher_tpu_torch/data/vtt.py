"""WebVTT cue parsing.

Parity with reference parse_vtts.py:1-53: timestamps in ``HH:MM:SS.sss`` or
``MM:SS.sss`` form; a cue is a ``-->`` line followed by text lines until the
next blank line; malformed cues are skipped, not fatal.
"""

from __future__ import annotations


def parse_timestamp(timestamp: str) -> float:
    """Parse a VTT timestamp to seconds (reference parse_vtts.py:1-21)."""
    parts = timestamp.split(":")
    last = parts[-1].split(".")
    seconds = int(last[0])
    millis = float("0." + last[1]) if len(last) > 1 else 0.0
    if len(parts) == 3:      # HH:MM:SS.sss
        return int(parts[0]) * 3600 + int(parts[1]) * 60 + seconds + millis
    if len(parts) == 2:      # MM:SS.sss
        return int(parts[0]) * 60 + seconds + millis
    raise ValueError(f"Timestamp format is incorrect: {timestamp}")


def vtt_to_segments_with_text(vtt_text: str) -> list[tuple[float, float, str]]:
    """Extract ``(start_sec, end_sec, text)`` cues from a VTT document.

    Same tolerant line-walk as reference parse_vtts.py:23-53: only lines with
    ``-->`` start a cue; text is joined with spaces; parse errors skip the cue.
    """
    segments: list[tuple[float, float, str]] = []
    lines = vtt_text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        if "-->" in line:
            try:
                lhs, rhs = line.split("-->")[:2]
                start_sec = parse_timestamp(lhs.strip())
                # Cue settings may trail the end timestamp ("00:01.000 align:start");
                # take the first whitespace-delimited token.
                end_sec = parse_timestamp(rhs.strip().split()[0])
                i += 1
                text_lines = []
                while i < len(lines) and lines[i].strip() != "":
                    text_lines.append(lines[i].strip())
                    i += 1
                segments.append((start_sec, end_sec, " ".join(text_lines)))
            except Exception:
                i += 1
                continue
        else:
            i += 1
    return segments
