from .fileformat import FileInfo, parse_filename, load_iq
