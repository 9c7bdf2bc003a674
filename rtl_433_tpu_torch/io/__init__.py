from .fileformat import FileInfo, parse_filename, load_iq, load_iq_bytes
