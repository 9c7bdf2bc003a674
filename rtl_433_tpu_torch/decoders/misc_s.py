"""Misc decoders batch S (reference files cited per function):
Bresser SmartHome Garden set (Baldr/Homgar family, also RainPoint).
"""

from __future__ import annotations

from ..bits import util
from ..output.data_model import Event
from .base import (
    DECODE_ABORT_EARLY,
    DECODE_ABORT_LENGTH,
    DECODE_FAIL_MIC,
    DECODE_FAIL_SANITY,
    decoder,
)


def _model(source_id):
    """Device class -> model name (ref src/devices/bresser_garden.c:22)."""
    return {0x47: "Bresser-SoilMoisture", 0x1F: "Bresser-WaterTimer",
            0x01: "Bresser-Gateway"}.get(source_id >> 24, "Bresser-Garden")


def _s16(v):
    return v - 0x10000 if v & 0x8000 else v


_BG_DAY_MODE = ["unknown", "every day", "odd days", "even days", "weekly",
                "unknown", "unknown", "unknown"]


@decoder("bresser_garden")
def bresser_garden(bits, dev):
    """Bresser SmartHome Garden set (ref src/devices/bresser_garden.c:434)."""
    pre = bytes([0xAA, 0xF3, 0xE9, 0x10, 0x5E, 0x51])
    if bits.num_rows != 1:
        return DECODE_FAIL_SANITY
    msg_len = bits.bits_per_row[0]
    if msg_len > 2000:
        return DECODE_ABORT_LENGTH
    offset = bits.search(0, 0, pre, 48)
    if offset >= msg_len:
        return DECODE_ABORT_EARLY
    offset += 48
    if msg_len - offset < 33 * 8:
        return DECODE_ABORT_LENGTH
    b = [int(x) for x in bits.extract_bytes(0, offset, 33 * 8)]
    if util.crc16(bytes(b), 33, 0x1021, 0xD636):
        return DECODE_FAIL_MIC
    target_id = (b[3] << 24) | (b[2] << 16) | (b[1] << 8) | b[0]
    source_id = (b[7] << 24) | (b[6] << 16) | (b[5] << 8) | b[4]
    counter = b[8]
    msg_type = b[9]
    msg_length = b[10]
    ack = msg_type >> 7
    if msg_length > 20:
        return DECODE_FAIL_SANITY
    model = _model(source_id)
    msg = "".join("%02x" % x for x in b[11:11 + msg_length])
    src = (source_id ^ 0x80000000) - 0x80000000
    tgt = (target_id ^ 0x80000000) - 0x80000000

    if msg_type == 0x01 and msg_length in (0x07, 0x08):
        return [Event.make(
            ("model", model),
            ("msg_name", "Init Pairing", ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("device_type", b[11], "", "%u"),
            ("firmware", b[17], "Firmware", "%u"),
            ("msg_type", msg_type, "", "%X"),
            ("msg_length", msg_length, "", "%02X"),
            ("msg", msg, ""),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x81 and msg_length == 0x10:
        return [Event.make(
            ("model", model),
            ("msg_name", "Pairing ack", ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("acknowledgement", ack, ""),
            ("msg_type", msg_type, "", "%X"),
            ("msg_length", msg_length, "", "%02X"),
            ("msg", msg, ""),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x03 and msg_length == 0x07:
        temperature_f = _s16((b[17] << 8) | b[16])
        return [Event.make(
            ("model", model),
            ("msg_name", "Soil telemetry", ""),
            ("id", src, "", "%u"),
            ("device_type", b[11], "", "%u"),
            ("station_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("temperature_F", temperature_f * 0.1, "Temperature",
             "%.1f F"),
            ("moisture", b[14], "Moisture", "%u %%"),
            ("battery_ok", int(not ((b[12] & 0x10) >> 4)), "Battery OK",
             "%u"),
            ("battery_level", b[12] & 0x0F, "Battery Level"),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type in (0x83, 0x84, 0x89, 0x8A) and msg_length == 0x01:
        return [Event.make(
            ("model", model),
            ("msg_name", "Acknowledgement", ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("acknowledgement", ack, ""),
            ("msg_type", msg_type, "", "%X"),
            ("msg_length", msg_length, "", "%02X"),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x0A and msg_length == 0x09:
        temperature_f = _s16((b[19] << 8) | b[18])
        return [Event.make(
            ("model", model),
            ("msg_name", "Relay telemetry", ""),
            ("id", src, "", "%u"),
            ("device_type", b[11], "", "%u"),
            ("sensor_number", b[12], "", "%u"),
            ("station_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("temperature_F", temperature_f * 0.1, "Temperature",
             "%.1f F"),
            ("moisture", b[16], "Moisture", "%u %%"),
            ("soil_rssi", b[13], "Soil RSSI"),
            ("battery_ok", int(not ((b[14] & 0x10) >> 4)), "Battery OK",
             "%u"),
            ("battery_level", b[14] & 0x0F, "Battery Level"),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x09 and msg_length == 0x09:
        temperature_f = _s16((b[19] << 8) | b[18])
        return [Event.make(
            ("model", model),
            ("msg_name", "Soil telemetry", ""),
            ("id", src, "", "%u"),
            ("device_type", b[11], "", "%u"),
            ("sensor_number", b[12], "", "%u"),
            ("station_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("temperature_F", temperature_f * 0.1, "Temperature",
             "%.1f F"),
            ("moisture", b[16], "Moisture", "%u %%"),
            ("battery_ok", int(not ((b[14] & 0x10) >> 4)), "Battery OK",
             "%u"),
            ("battery_level", b[14] & 0x0F, "Battery Level"),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x04 and msg_length == 0x0E:
        return [Event.make(
            ("model", model),
            ("msg_name", "Watering", ""),
            ("id", src, "", "%u"),
            ("sensor_number", b[11], "", "%u"),
            ("station_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("programme", (b[14] << 8) | b[15], "", "%04x"),
            ("cycle_counter", b[16] | (b[17] << 8), ""),
            ("trigger", b[18], "", "%02x"),
            ("water_usage_l", (b[19] | (b[20] << 8)) * 0.1, "Water Usage",
             "%.1f l"),
            ("duration_s", b[23] | (b[24] << 8), "Duration", "%u s"),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x85 and msg_length == 0x0F:
        flow_rate = b[24] - 256 if b[24] & 0x80 else b[24]
        return [Event.make(
            ("model", model),
            ("msg_name", "Schedule config", ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("sensor_number", b[18], "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("default_duration_s", b[12] | (b[13] << 8),
             "Default Duration", "%u s"),
            ("mist_run_s", b[14] | (b[15] << 8), "Mist Run", "%u s"),
            ("mist_interval_s", b[16] | (b[17] << 8), "Mist Interval",
             "%u s"),
            ("stop_moisture", b[19], "Stop Moisture", "%u %%"),
            ("flow_rate", flow_rate, "Flow Rate", "%d %%"),
            ("unknown", b[22], "Unknown", "%02x"),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x20 and msg_length in (0x02, 0x03):
        has_channel = msg_length == 0x03 and b[12] == 0x04
        return [Event.make(
            ("model", model),
            ("msg_name", "Config change", ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("config_counter", b[11], ""),
            ("rf_channel", b[13], "RF Channel") if has_channel else None,
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x86 and msg_length in (0x08, 0x0F):
        plans = []
        n_plans = (msg_length - 1) // 7
        for p in range(n_plans):
            if len(plans) >= 2 or 12 + p * 7 + 6 >= 33:
                break
            r = b[12 + p * 7:12 + p * 7 + 7]
            plans.append(Event.make(
                ("plan", len(plans) + 1, ""),
                ("enabled", 1 if r[0] & 0x80 else 0, ""),
                ("irrigation",
                 "misting" if r[2] & 0x80 else "normal", ""),
                ("start_hour", ((r[2] & 0x07) << 2) | (r[1] >> 6), ""),
                ("start_minute", r[1] & 0x3F, ""),
                ("day_mode", _BG_DAY_MODE[(r[2] >> 3) & 0x07], ""),
                ("weekday_mask", r[0] & 0x7F, "", "%02x"),
                ("duration_s", r[3] | (r[4] << 8), "Duration", "%u s"),
                ("water_limit_l", (r[5] | (r[6] << 8)) / 10.0, "",
                 "%.1f L"),
            ))
        return [Event.make(
            ("model", model),
            ("msg_name", "Schedule", ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("more_parts", 1 if b[11] else 0, ""),
            ("msg_type", msg_type, "", "%02X"),
            ("plans", plans, ""),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x21 and msg_length >= 0x03:
        variant = b[12]
        mode = b[13]
        duration_s = b[14] if msg_length >= 0x04 else 0
        if msg_length >= 0x05:
            duration_s |= b[15] << 8
        is_run = variant == 0x02
        status = ("Heartbeat" if not is_run
                  else ("Run stop" if mode == 0 else "Run start"))
        return [Event.make(
            ("model", model),
            ("msg_name", status, ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("mode", mode, "") if is_run else None,
            ("duration_s", duration_s, "Duration", "%u s")
            if is_run and msg_length >= 0x04 else None,
            ("heartbeat_interval_s", duration_s, "")
            if not is_run and msg_length >= 0x04 else None,
            ("msg", msg, ""),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type in (0xA0, 0xA1):
        has_run = (msg_type == 0xA1 and msg_length >= 0x0D
                   and b[13] == 0x9F and b[18] == 0x81 and b[21] == 0xAD)
        status = ("Acknowledgement" if msg_type == 0xA0
                  else ("Run response" if has_run else "Beacon"))
        return [Event.make(
            ("model", model),
            ("msg_name", status, ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("trigger", b[12], "", "%02x") if has_run else None,
            ("duration_s", b[22] | (b[23] << 8), "Duration", "%u s")
            if has_run else None,
            ("remaining_s", b[19] | (b[20] << 8), "Remaining", "%u s")
            if has_run else None,
            ("water_usage_l", (b[14] | (b[15] << 8)) * 0.1, "Water Usage",
             "%.1f l") if has_run else None,
            ("acknowledgement", ack, ""),
            ("msg", msg, ""),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x82 and msg_length >= 0x02:
        return [Event.make(
            ("model", model),
            ("msg_name", "Status response", ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("config_counter", b[12], ""),
            ("gateway_time", b[13] | (b[14] << 8) | (b[15] << 16), "")
            if msg_length >= 0x05 else None,
            ("msg", msg, ""),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type == 0x88 and msg_length >= 0x03:
        return [Event.make(
            ("model", model),
            ("msg_name", "Moisture response", ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("moisture", b[13], "Moisture", "%u %%"),
            ("msg", msg, ""),
            ("mic", "CRC", "Integrity"),
        )]
    if msg_type in (0x02, 0x05, 0x06, 0x08):
        status = {0x02: "Status report", 0x05: "Config request",
                  0x08: "Moisture request"}.get(msg_type,
                                                "Schedule request")
        has_run = (msg_type == 0x02 and msg_length >= 0x0F
                   and b[20] == 0x81 and b[23] == 0xAD)
        return [Event.make(
            ("model", model),
            ("msg_name", status, ""),
            ("id", src, "", "%u"),
            ("target_id", tgt, "", "%u"),
            ("msg_counter", counter, "Msg Counter"),
            ("msg_type", msg_type, "", "%02X"),
            ("msg_length", msg_length, "", "%02X"),
            ("trigger", b[14], "", "%02x") if has_run else None,
            ("duration_s", b[24] | (b[25] << 8), "Duration", "%u s")
            if has_run else None,
            ("remaining_s", b[21] | (b[22] << 8), "Remaining", "%u s")
            if has_run else None,
            ("water_usage_l", (b[16] | (b[17] << 8)) * 0.1, "Water Usage",
             "%.1f l") if has_run else None,
            ("msg", msg, ""),
            ("mic", "CRC", "Integrity"),
        )]
    return [Event.make(
        ("model", model),
        ("msg_name", "Unknown msg", ""),
        ("id", src, "", "%u"),
        ("target_id", tgt, "", "%u"),
        ("msg_counter", counter, "Msg Counter"),
        ("acknowledgement", ack, ""),
        ("msg_type", msg_type, "", "%02X"),
        ("msg_length", msg_length, "", "%02X"),
        ("msg", msg, ""),
        ("mic", "CRC", "Integrity"),
    )]
