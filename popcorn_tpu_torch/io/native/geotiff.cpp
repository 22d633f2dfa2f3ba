// geotiff.cpp — native windowed GeoTIFF reader/writer for popcorn_tpu_torch.
//
// The reference framework's raster data plane is GDAL/rasterio (C++):
// windowed reads of country-scale seasonal mosaics
// (data/PopulationDataset.py:554-621), VRT mosaics over raw tiles
// (:195-219) and GeoTIFF prediction writes (:855-880). This library is the
// port's native equivalent: a dependency-free TIFF 6.0 / BigTIFF
// implementation with
//   * windowed reads of striped & tiled images, chunky or planar layout
//   * dtypes u8/i8/u16/i16/u32/i32/f32/f64 -> float32 output
//   * compressions: none(1), LZW(5), Deflate(8/32946), PackBits(32773)
//   * predictors: none(1), horizontal(2), floating-point(3)
//   * GeoTIFF tag passthrough (pixel scale, tiepoint, transformation,
//     geo key directory, ascii/double params, GDAL nodata/metadata)
//   * tiled Deflate writer (float32/u8/u16/i32) with BigTIFF escalation
//   * multi-threaded tile decode (thread pool sized to hardware cores)
//
// Exposed via a C ABI consumed from Python with ctypes
// (popcorn_tpu_torch/io/geotiff.py).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 geotiff.cpp -o libpopgeotiff.so -lz -lpthread

#include <algorithm>
#include <atomic>
#include <cinttypes>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------- utilities

struct Err {
  char* buf;
  int len;
  void set(const std::string& msg) {
    if (buf && len > 0) {
      std::snprintf(buf, (size_t)len, "%s", msg.c_str());
    }
  }
};

// TIFF tag ids
enum : uint16_t {
  TAG_WIDTH = 256,
  TAG_HEIGHT = 257,
  TAG_BITS = 258,
  TAG_COMPRESSION = 259,
  TAG_PHOTOMETRIC = 262,
  TAG_STRIP_OFFSETS = 273,
  TAG_SPP = 277,
  TAG_ROWS_PER_STRIP = 278,
  TAG_STRIP_BYTECOUNTS = 279,
  TAG_PLANARCONFIG = 284,
  TAG_PREDICTOR = 317,
  TAG_TILE_WIDTH = 322,
  TAG_TILE_HEIGHT = 323,
  TAG_TILE_OFFSETS = 324,
  TAG_TILE_BYTECOUNTS = 325,
  TAG_SAMPLEFORMAT = 339,
  TAG_MODEL_PIXEL_SCALE = 33550,
  TAG_MODEL_TIEPOINT = 33922,
  TAG_MODEL_TRANSFORMATION = 34264,
  TAG_GEO_KEYS = 34735,
  TAG_GEO_DOUBLES = 34736,
  TAG_GEO_ASCII = 34737,
  TAG_GDAL_METADATA = 42112,
  TAG_GDAL_NODATA = 42113,
};

// TIFF field types
enum : uint16_t {
  T_BYTE = 1,
  T_ASCII = 2,
  T_SHORT = 3,
  T_LONG = 4,
  T_RATIONAL = 5,
  T_SBYTE = 6,
  T_UNDEFINED = 7,
  T_SSHORT = 8,
  T_SLONG = 9,
  T_SRATIONAL = 10,
  T_FLOAT = 11,
  T_DOUBLE = 12,
  T_LONG8 = 16,
  T_SLONG8 = 17,
  T_IFD8 = 18,
};

size_t type_size(uint16_t t) {
  switch (t) {
    case T_BYTE: case T_ASCII: case T_SBYTE: case T_UNDEFINED: return 1;
    case T_SHORT: case T_SSHORT: return 2;
    case T_LONG: case T_SLONG: case T_FLOAT: return 4;
    case T_RATIONAL: case T_SRATIONAL: case T_DOUBLE:
    case T_LONG8: case T_SLONG8: case T_IFD8: return 8;
    default: return 0;
  }
}

// sample dtype enum shared with Python
enum DType : int {
  DT_UNKNOWN = 0,
  DT_U8 = 1,
  DT_I8 = 2,
  DT_U16 = 3,
  DT_I16 = 4,
  DT_U32 = 5,
  DT_I32 = 6,
  DT_F32 = 7,
  DT_F64 = 8,
};

size_t dtype_size(int dt) {
  switch (dt) {
    case DT_U8: case DT_I8: return 1;
    case DT_U16: case DT_I16: return 2;
    case DT_U32: case DT_I32: case DT_F32: return 4;
    case DT_F64: return 8;
    default: return 0;
  }
}

struct ByteSwapper {
  bool swap;
  uint16_t u16(uint16_t v) const {
    return swap ? (uint16_t)((v >> 8) | (v << 8)) : v;
  }
  uint32_t u32(uint32_t v) const {
    return swap ? __builtin_bswap32(v) : v;
  }
  uint64_t u64(uint64_t v) const {
    return swap ? __builtin_bswap64(v) : v;
  }
};

struct TagEntry {
  uint16_t tag = 0;
  uint16_t type = 0;
  uint64_t count = 0;
  std::vector<uint8_t> data;  // raw (native-endian already normalised)

  // interpret as unsigned ints
  std::vector<uint64_t> as_uints() const {
    std::vector<uint64_t> out;
    size_t ts = type_size(type);
    for (uint64_t i = 0; i < count; ++i) {
      const uint8_t* p = data.data() + i * ts;
      uint64_t v = 0;
      switch (type) {
        case T_BYTE: case T_UNDEFINED: v = *p; break;
        case T_SHORT: { uint16_t x; memcpy(&x, p, 2); v = x; break; }
        case T_LONG: { uint32_t x; memcpy(&x, p, 4); v = x; break; }
        case T_LONG8: case T_IFD8: { uint64_t x; memcpy(&x, p, 8); v = x; break; }
        default: v = 0;
      }
      out.push_back(v);
    }
    return out;
  }
  std::vector<double> as_doubles() const {
    std::vector<double> out;
    size_t ts = type_size(type);
    for (uint64_t i = 0; i < count; ++i) {
      const uint8_t* p = data.data() + i * ts;
      double v = 0;
      switch (type) {
        case T_DOUBLE: { double x; memcpy(&x, p, 8); v = x; break; }
        case T_FLOAT: { float x; memcpy(&x, p, 4); v = x; break; }
        case T_SHORT: { uint16_t x; memcpy(&x, p, 2); v = x; break; }
        case T_LONG: { uint32_t x; memcpy(&x, p, 4); v = x; break; }
        default: v = 0;
      }
      out.push_back(v);
    }
    return out;
  }
};

// -------------------------------------------------------------- decompressors

bool inflate_zlib(const uint8_t* src, size_t srclen, uint8_t* dst, size_t dstlen) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)srclen;
  zs.next_out = dst;
  zs.avail_out = (uInt)dstlen;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END || (rc == Z_OK && zs.avail_out == 0) ||
         (rc == Z_BUF_ERROR && zs.avail_out == 0);
}

// TIFF LZW (MSB-first codes, early-change) decoder.
bool lzw_decode(const uint8_t* src, size_t srclen, uint8_t* dst, size_t dstlen) {
  constexpr int CLEAR = 256, EOI = 257;
  struct Entry { int prev; uint8_t ch; int len; };
  std::vector<Entry> table(4096);
  for (int i = 0; i < 256; ++i) table[i] = { -1, (uint8_t)i, 1 };
  int next_code = 258;
  int code_bits = 9;

  size_t out = 0;
  uint64_t bitbuf = 0;
  int bits = 0;
  size_t pos = 0;
  int prev_code = -1;
  std::vector<uint8_t> scratch(4096);

  auto emit = [&](int code) -> bool {
    int len = table[code].len;
    if (out + (size_t)len > dstlen) len = (int)(dstlen - out);
    int full = table[code].len;
    // write backwards
    int c = code;
    for (int i = full - 1; i >= 0; --i) {
      scratch[i] = table[c].ch;
      c = table[c].prev;
    }
    int n = std::min((size_t)full, dstlen - out);
    memcpy(dst + out, scratch.data(), n);
    out += n;
    return true;
  };

  while (out < dstlen) {
    while (bits < code_bits && pos < srclen) {
      bitbuf = (bitbuf << 8) | src[pos++];
      bits += 8;
    }
    if (bits < code_bits) break;
    int code = (int)((bitbuf >> (bits - code_bits)) & ((1u << code_bits) - 1));
    bits -= code_bits;

    if (code == EOI) break;
    if (code == CLEAR) {
      next_code = 258;
      code_bits = 9;
      prev_code = -1;
      continue;
    }
    if (prev_code < 0) {
      if (code >= 256) return false;
      emit(code);
      prev_code = code;
      continue;
    }
    if (code < next_code) {
      // known code
      if (next_code < 4096) {
        int c = code;
        while (table[c].prev >= 0) c = table[c].prev;
        table[next_code] = { prev_code, table[c].ch, table[prev_code].len + 1 };
        next_code++;
      }
      emit(code);
    } else if (code == next_code) {
      // KwKwK case
      int c = prev_code;
      while (table[c].prev >= 0) c = table[c].prev;
      if (next_code < 4096) {
        table[next_code] = { prev_code, table[c].ch, table[prev_code].len + 1 };
        next_code++;
      }
      emit(code < 4096 ? code : prev_code);
    } else {
      return false;
    }
    prev_code = code;
    // early change: bump width one code before the table fills
    if (next_code == (1 << code_bits) - 1 && code_bits < 12) code_bits++;
  }
  return true;
}

bool packbits_decode(const uint8_t* src, size_t srclen, uint8_t* dst, size_t dstlen) {
  size_t i = 0, o = 0;
  while (i < srclen && o < dstlen) {
    int8_t n = (int8_t)src[i++];
    if (n >= 0) {
      size_t cnt = (size_t)n + 1;
      cnt = std::min(cnt, dstlen - o);
      if (i + cnt > srclen) return false;
      memcpy(dst + o, src + i, cnt);
      i += cnt;
      o += cnt;
    } else if (n != -128) {
      size_t cnt = (size_t)(-n) + 1;
      if (i >= srclen) return false;
      cnt = std::min(cnt, dstlen - o);
      memset(dst + o, src[i++], cnt);
      o += cnt;
    }
  }
  return true;
}

// predictor 2: horizontal differencing per row, per sample component
void undo_predictor2(uint8_t* buf, size_t rows, size_t cols, size_t comps,
                     size_t sample_bytes) {
  for (size_t r = 0; r < rows; ++r) {
    uint8_t* row = buf + r * cols * comps * sample_bytes;
    if (sample_bytes == 1) {
      for (size_t c = comps; c < cols * comps; ++c) row[c] = (uint8_t)(row[c] + row[c - comps]);
    } else if (sample_bytes == 2) {
      uint16_t* p = (uint16_t*)row;
      for (size_t c = comps; c < cols * comps; ++c) p[c] = (uint16_t)(p[c] + p[c - comps]);
    } else if (sample_bytes == 4) {
      uint32_t* p = (uint32_t*)row;
      for (size_t c = comps; c < cols * comps; ++c) p[c] = p[c] + p[c - comps];
    }
  }
}

// predictor 3: floating point byte-plane shuffle + differencing
void undo_predictor3(uint8_t* buf, size_t rows, size_t cols, size_t comps,
                     size_t sample_bytes, bool /*big_endian_file*/) {
  size_t rowlen = cols * comps * sample_bytes;
  std::vector<uint8_t> tmp(rowlen);
  for (size_t r = 0; r < rows; ++r) {
    uint8_t* row = buf + r * rowlen;
    // 1) undo byte-wise horizontal differencing
    for (size_t i = 1; i < rowlen; ++i) row[i] = (uint8_t)(row[i] + row[i - 1]);
    // 2) de-interleave byte planes (stored big-endian-split)
    size_t n = cols * comps;
    for (size_t i = 0; i < n; ++i) {
      for (size_t b = 0; b < sample_bytes; ++b) {
        tmp[i * sample_bytes + (sample_bytes - 1 - b)] = row[b * n + i];
      }
    }
    memcpy(row, tmp.data(), rowlen);
  }
}

// ------------------------------------------------------------------- reader

struct Reader {
  FILE* f = nullptr;
  ByteSwapper bs{false};
  bool big = false;  // BigTIFF
  uint64_t width = 0, height = 0;
  uint16_t spp = 1;           // samples per pixel (bands)
  uint16_t planar = 1;        // 1 chunky, 2 planar
  uint16_t compression = 1;
  uint16_t predictor = 1;
  int dtype = DT_UNKNOWN;
  size_t sample_bytes = 0;
  bool tiled = false;
  uint64_t tile_w = 0, tile_h = 0;        // tiles
  uint64_t rows_per_strip = 0;            // strips
  std::vector<uint64_t> chunk_offsets;    // tile or strip offsets
  std::vector<uint64_t> chunk_counts;     // byte counts
  std::map<uint16_t, TagEntry> geo_tags;  // raw geo/GDAL tags for passthrough
  double nodata = NAN;
  bool has_nodata = false;
  std::mutex io_mutex;

  ~Reader() {
    if (f) fclose(f);
  }

  bool read_at(uint64_t off, void* dst, size_t n) {
    std::lock_guard<std::mutex> lock(io_mutex);
    if (fseeko(f, (off_t)off, SEEK_SET) != 0) return false;
    return fread(dst, 1, n, f) == n;
  }

  bool open(const char* path, Err& err) {
    f = fopen(path, "rb");
    if (!f) {
      err.set(std::string("cannot open ") + path);
      return false;
    }
    uint8_t hdr[16];
    if (fread(hdr, 1, 8, f) != 8) {
      err.set("short header");
      return false;
    }
    if (hdr[0] == 'I' && hdr[1] == 'I') bs.swap = false;
    else if (hdr[0] == 'M' && hdr[1] == 'M') bs.swap = true;
    else {
      err.set("not a TIFF");
      return false;
    }
#if __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
    bs.swap = !bs.swap;
#endif
    uint16_t magic;
    memcpy(&magic, hdr + 2, 2);
    magic = bs.u16(magic);
    uint64_t ifd_off = 0;
    if (magic == 42) {
      big = false;
      uint32_t o;
      memcpy(&o, hdr + 4, 4);
      ifd_off = bs.u32(o);
    } else if (magic == 43) {
      big = true;
      if (fread(hdr + 8, 1, 8, f) != 8) { err.set("short bigtiff header"); return false; }
      uint64_t o;
      memcpy(&o, hdr + 8, 8);
      ifd_off = bs.u64(o);
    } else {
      err.set("bad TIFF magic");
      return false;
    }
    return parse_ifd(ifd_off, err);
  }

  bool read_entry_data(TagEntry& e, uint64_t value_field, const uint8_t* inline_ptr,
                       size_t inline_cap) {
    size_t total = (size_t)e.count * type_size(e.type);
    e.data.resize(total);
    if (total <= inline_cap) {
      memcpy(e.data.data(), inline_ptr, total);
    } else {
      if (!read_at(value_field, e.data.data(), total)) return false;
    }
    // normalise endianness in place
    if (bs.swap) {
      size_t ts = type_size(e.type);
      if (ts == 2) {
        uint16_t* p = (uint16_t*)e.data.data();
        for (uint64_t i = 0; i < e.count; ++i) p[i] = __builtin_bswap16(p[i]);
      } else if (ts == 4) {
        uint32_t* p = (uint32_t*)e.data.data();
        for (uint64_t i = 0; i < e.count; ++i) p[i] = __builtin_bswap32(p[i]);
      } else if (ts == 8) {
        uint64_t* p = (uint64_t*)e.data.data();
        for (uint64_t i = 0; i < e.count; ++i) p[i] = __builtin_bswap64(p[i]);
      }
    }
    return true;
  }

  bool parse_ifd(uint64_t off, Err& err) {
    uint64_t nentries = 0;
    if (big) {
      uint64_t n;
      if (!read_at(off, &n, 8)) { err.set("bad IFD"); return false; }
      nentries = bs.u64(n);
      off += 8;
    } else {
      uint16_t n;
      if (!read_at(off, &n, 2)) { err.set("bad IFD"); return false; }
      nentries = bs.u16(n);
      off += 2;
    }
    size_t esz = big ? 20 : 12;
    std::vector<uint8_t> raw(esz * nentries);
    if (!read_at(off, raw.data(), raw.size())) { err.set("bad IFD entries"); return false; }

    std::vector<uint16_t> bits;
    std::vector<uint16_t> sformat;

    for (uint64_t i = 0; i < nentries; ++i) {
      const uint8_t* p = raw.data() + i * esz;
      TagEntry e;
      uint16_t tag_, type_;
      memcpy(&tag_, p, 2);
      memcpy(&type_, p + 2, 2);
      e.tag = bs.u16(tag_);
      e.type = bs.u16(type_);
      uint64_t value_field;
      size_t inline_cap;
      const uint8_t* inline_ptr;
      if (big) {
        uint64_t cnt;
        memcpy(&cnt, p + 4, 8);
        e.count = bs.u64(cnt);
        uint64_t v;
        memcpy(&v, p + 12, 8);
        value_field = bs.u64(v);
        inline_cap = 8;
        inline_ptr = p + 12;
      } else {
        uint32_t cnt;
        memcpy(&cnt, p + 4, 4);
        e.count = bs.u32(cnt);
        uint32_t v;
        memcpy(&v, p + 8, 4);
        value_field = bs.u32(v);
        inline_cap = 4;
        inline_ptr = p + 8;
      }
      // For inline data with swapped endianness the raw bytes are in file
      // order; read_entry_data handles normalisation but inline values were
      // copied from the swapped entry — handle by re-reading via memcpy of
      // original bytes (they are file-order bytes, normalisation applies).
      if (!read_entry_data(e, value_field, inline_ptr, inline_cap)) {
        err.set("bad tag data");
        return false;
      }

      switch (e.tag) {
        case TAG_WIDTH: width = e.as_uints()[0]; break;
        case TAG_HEIGHT: height = e.as_uints()[0]; break;
        case TAG_BITS: {
          auto v = e.as_uints();
          for (auto x : v) bits.push_back((uint16_t)x);
          break;
        }
        case TAG_COMPRESSION: compression = (uint16_t)e.as_uints()[0]; break;
        case TAG_SPP: spp = (uint16_t)e.as_uints()[0]; break;
        case TAG_PLANARCONFIG: planar = (uint16_t)e.as_uints()[0]; break;
        case TAG_PREDICTOR: predictor = (uint16_t)e.as_uints()[0]; break;
        case TAG_ROWS_PER_STRIP: rows_per_strip = e.as_uints()[0]; break;
        case TAG_STRIP_OFFSETS: chunk_offsets = e.as_uints(); tiled = false; break;
        case TAG_STRIP_BYTECOUNTS: chunk_counts = e.as_uints(); break;
        case TAG_TILE_WIDTH: tile_w = e.as_uints()[0]; break;
        case TAG_TILE_HEIGHT: tile_h = e.as_uints()[0]; break;
        case TAG_TILE_OFFSETS: chunk_offsets = e.as_uints(); tiled = true; break;
        case TAG_TILE_BYTECOUNTS: chunk_counts = e.as_uints(); break;
        case TAG_SAMPLEFORMAT: {
          auto v = e.as_uints();
          for (auto x : v) sformat.push_back((uint16_t)x);
          break;
        }
        case TAG_MODEL_PIXEL_SCALE:
        case TAG_MODEL_TIEPOINT:
        case TAG_MODEL_TRANSFORMATION:
        case TAG_GEO_KEYS:
        case TAG_GEO_DOUBLES:
        case TAG_GEO_ASCII:
        case TAG_GDAL_METADATA:
          geo_tags[e.tag] = e;
          break;
        case TAG_GDAL_NODATA: {
          geo_tags[e.tag] = e;
          std::string s((const char*)e.data.data(), e.data.size());
          try {
            nodata = std::stod(s);
            has_nodata = true;
          } catch (...) {}
          break;
        }
        default: break;
      }
    }

    uint16_t b = bits.empty() ? 1 : bits[0];
    uint16_t sf = sformat.empty() ? 1 : sformat[0];
    if (b == 8) dtype = sf == 2 ? DT_I8 : DT_U8;
    else if (b == 16) dtype = sf == 2 ? DT_I16 : DT_U16;
    else if (b == 32) dtype = sf == 3 ? DT_F32 : (sf == 2 ? DT_I32 : DT_U32);
    else if (b == 64 && sf == 3) dtype = DT_F64;
    else {
      err.set("unsupported bits/sampleformat");
      return false;
    }
    sample_bytes = dtype_size(dtype);
    if (!tiled && rows_per_strip == 0) rows_per_strip = height;
    if (width == 0 || height == 0 || chunk_offsets.empty()) {
      err.set("missing required tags");
      return false;
    }
    return true;
  }

  // number of chunk columns/rows for tiled layout
  uint64_t tiles_across() const { return (width + tile_w - 1) / tile_w; }
  uint64_t tiles_down() const { return (height + tile_h - 1) / tile_h; }
  uint64_t strips_count() const { return (height + rows_per_strip - 1) / rows_per_strip; }

  // Decode one chunk (tile or strip) for plane `pl` (planar) into a raw
  // buffer of chunk_rows*chunk_cols*comps samples.
  bool decode_chunk(uint64_t chunk_index, std::vector<uint8_t>& out,
                    uint64_t chunk_rows, uint64_t chunk_cols, uint64_t comps) {
    if (chunk_index >= chunk_offsets.size()) return false;
    uint64_t off = chunk_offsets[chunk_index];
    uint64_t cnt = chunk_index < chunk_counts.size() ? chunk_counts[chunk_index] : 0;
    size_t rawlen = (size_t)chunk_rows * chunk_cols * comps * sample_bytes;
    out.assign(rawlen, 0);
    if (off == 0 || cnt == 0) {
      // sparse chunk (GDAL writes these for empty regions): fill nodata
      if (has_nodata || dtype == DT_F32 || dtype == DT_F64) {
        fill_value(out.data(), rawlen / sample_bytes, has_nodata ? nodata : 0.0);
      }
      return true;
    }
    std::vector<uint8_t> comp(cnt);
    if (!read_at(off, comp.data(), cnt)) return false;

    bool ok = true;
    switch (compression) {
      case 1:
        if (cnt < rawlen) return false;
        memcpy(out.data(), comp.data(), rawlen);
        break;
      case 5:
        ok = lzw_decode(comp.data(), cnt, out.data(), rawlen);
        break;
      case 8:
      case 32946:
        ok = inflate_zlib(comp.data(), cnt, out.data(), rawlen);
        break;
      case 32773:
        ok = packbits_decode(comp.data(), cnt, out.data(), rawlen);
        break;
      default:
        return false;
    }
    if (!ok) return false;

    if (predictor == 2) {
      undo_predictor2(out.data(), chunk_rows, chunk_cols, comps, sample_bytes);
    } else if (predictor == 3) {
      undo_predictor3(out.data(), chunk_rows, chunk_cols, comps, sample_bytes, false);
    }
    // byte-swap samples if file endianness != host
    if (bs.swap && predictor != 3 && sample_bytes > 1) {
      size_t n = rawlen / sample_bytes;
      if (sample_bytes == 2) {
        uint16_t* p = (uint16_t*)out.data();
        for (size_t i = 0; i < n; ++i) p[i] = __builtin_bswap16(p[i]);
      } else if (sample_bytes == 4) {
        uint32_t* p = (uint32_t*)out.data();
        for (size_t i = 0; i < n; ++i) p[i] = __builtin_bswap32(p[i]);
      } else if (sample_bytes == 8) {
        uint64_t* p = (uint64_t*)out.data();
        for (size_t i = 0; i < n; ++i) p[i] = __builtin_bswap64(p[i]);
      }
    }
    return true;
  }

  void fill_value(uint8_t* buf, size_t nsamples, double v) {
    switch (dtype) {
      case DT_U8: { uint8_t x = (uint8_t)v; memset(buf, x, nsamples); break; }
      case DT_I8: { int8_t x = (int8_t)v; memset(buf, (uint8_t)x, nsamples); break; }
      case DT_U16: { uint16_t x = (uint16_t)v; uint16_t* p = (uint16_t*)buf; for (size_t i = 0; i < nsamples; ++i) p[i] = x; break; }
      case DT_I16: { int16_t x = (int16_t)v; int16_t* p = (int16_t*)buf; for (size_t i = 0; i < nsamples; ++i) p[i] = x; break; }
      case DT_U32: { uint32_t x = (uint32_t)v; uint32_t* p = (uint32_t*)buf; for (size_t i = 0; i < nsamples; ++i) p[i] = x; break; }
      case DT_I32: { int32_t x = (int32_t)v; int32_t* p = (int32_t*)buf; for (size_t i = 0; i < nsamples; ++i) p[i] = x; break; }
      case DT_F32: { float x = (float)v; float* p = (float*)buf; for (size_t i = 0; i < nsamples; ++i) p[i] = x; break; }
      case DT_F64: { double* p = (double*)buf; for (size_t i = 0; i < nsamples; ++i) p[i] = v; break; }
    }
  }

  inline float to_f32(const uint8_t* p) const {
    switch (dtype) {
      case DT_U8: return (float)(*p);
      case DT_I8: return (float)(*(const int8_t*)p);
      case DT_U16: { uint16_t x; memcpy(&x, p, 2); return (float)x; }
      case DT_I16: { int16_t x; memcpy(&x, p, 2); return (float)x; }
      case DT_U32: { uint32_t x; memcpy(&x, p, 4); return (float)x; }
      case DT_I32: { int32_t x; memcpy(&x, p, 4); return (float)x; }
      case DT_F32: { float x; memcpy(&x, p, 4); return x; }
      case DT_F64: { double x; memcpy(&x, p, 8); return (float)x; }
      default: return 0.f;
    }
  }

  // dtype-specialised strided row conversion: one branch per row instead of
  // one switch per pixel (the per-pixel form dominated windowed-read time).
  template <typename T>
  static void copy_row_t(float* dst, const uint8_t* src, int64_t n,
                         size_t stride_bytes) {
    for (int64_t i = 0; i < n; ++i) {
      T v;
      memcpy(&v, src, sizeof(T));
      dst[i] = (float)v;
      src += stride_bytes;
    }
  }

  inline void copy_row(float* dst, const uint8_t* src, int64_t n,
                       size_t stride_bytes) const {
    switch (dtype) {
      case DT_U8: copy_row_t<uint8_t>(dst, src, n, stride_bytes); break;
      case DT_I8: copy_row_t<int8_t>(dst, src, n, stride_bytes); break;
      case DT_U16: copy_row_t<uint16_t>(dst, src, n, stride_bytes); break;
      case DT_I16: copy_row_t<int16_t>(dst, src, n, stride_bytes); break;
      case DT_U32: copy_row_t<uint32_t>(dst, src, n, stride_bytes); break;
      case DT_I32: copy_row_t<int32_t>(dst, src, n, stride_bytes); break;
      case DT_F32:
        if (stride_bytes == 4) {
          memcpy(dst, src, (size_t)n * 4);
        } else {
          copy_row_t<float>(dst, src, n, stride_bytes);
        }
        break;
      case DT_F64: copy_row_t<double>(dst, src, n, stride_bytes); break;
      default: break;
    }
  }

  // Strided raw copy in the file's native dtype (no conversion): the fast
  // path for uint16 S2 mosaics feeding the device-resident eval feed —
  // half the output bytes of the float32 conversion and a straight memcpy
  // when the band is alone in its plane.
  static void copy_row_raw(uint8_t* dst, const uint8_t* src, int64_t n,
                           size_t stride_bytes, size_t sb) {
    if (stride_bytes == sb) {
      memcpy(dst, src, (size_t)n * sb);
      return;
    }
    for (int64_t i = 0; i < n; ++i) {
      memcpy(dst, src, sb);
      dst += sb;
      src += stride_bytes;
    }
  }

  // Windowed read of `nbands` 1-based band indices into out[b][h][w]:
  // float32 (raw=false, converted) or the file's native dtype (raw=true).
  bool read_window(const int* bands, int nbands, int64_t x0, int64_t y0,
                   int64_t win_w, int64_t win_h, uint8_t* out, bool raw,
                   Err& err) {
    if (x0 < 0 || y0 < 0 || x0 + win_w > (int64_t)width ||
        y0 + win_h > (int64_t)height) {
      err.set("window out of bounds");
      return false;
    }
    for (int b = 0; b < nbands; ++b) {
      if (bands[b] < 1 || bands[b] > (int)spp) {
        err.set("band index out of range");
        return false;
      }
    }

    uint64_t comps = planar == 1 ? spp : 1;

    if (tiled) {
      uint64_t tx0 = (uint64_t)x0 / tile_w, tx1 = (uint64_t)(x0 + win_w - 1) / tile_w;
      uint64_t ty0 = (uint64_t)y0 / tile_h, ty1 = (uint64_t)(y0 + win_h - 1) / tile_h;
      uint64_t ntx = tiles_across(), nty = tiles_down();
      uint64_t tiles_per_plane = ntx * nty;

      struct Job { uint64_t ty, tx; int plane; int band_slot; };
      std::vector<Job> jobs;
      for (uint64_t ty = ty0; ty <= ty1; ++ty)
        for (uint64_t tx = tx0; tx <= tx1; ++tx) {
          if (planar == 1) {
            jobs.push_back({ty, tx, 0, -1});
          } else {
            for (int b = 0; b < nbands; ++b)
              jobs.push_back({ty, tx, bands[b] - 1, b});
          }
        }

      std::atomic<size_t> next{0};
      std::atomic<bool> failed{false};
      unsigned nthreads = std::min<unsigned>(
          std::max(1u, std::thread::hardware_concurrency()), (unsigned)jobs.size());

      auto worker = [&]() {
        std::vector<uint8_t> buf;
        while (true) {
          size_t j = next.fetch_add(1);
          if (j >= jobs.size() || failed.load()) break;
          const Job& job = jobs[j];
          uint64_t idx = job.plane * tiles_per_plane + job.ty * ntx + job.tx;
          if (!decode_chunk(idx, buf, tile_h, tile_w, comps)) {
            failed.store(true);
            break;
          }
          // copy intersecting region into out
          int64_t gx0 = (int64_t)(job.tx * tile_w), gy0 = (int64_t)(job.ty * tile_h);
          int64_t ix0 = std::max(x0, gx0), ix1 = std::min(x0 + win_w, gx0 + (int64_t)tile_w);
          int64_t iy0 = std::max(y0, gy0), iy1 = std::min(y0 + win_h, gy0 + (int64_t)tile_h);
          for (int64_t y = iy0; y < iy1; ++y) {
            const uint8_t* row =
                buf.data() + ((size_t)(y - gy0) * tile_w) * comps * sample_bytes;
            for (int b = 0; b < nbands; ++b) {
              if (planar == 2 && job.band_slot != b) continue;
              int comp = planar == 1 ? bands[b] - 1 : 0;
              size_t osb = raw ? sample_bytes : 4;
              uint8_t* orow =
                  out +
                  (((size_t)b * win_h + (y - y0)) * win_w + (ix0 - x0)) * osb;
              const uint8_t* src =
                  row + ((size_t)(ix0 - gx0) * comps + comp) * sample_bytes;
              if (raw)
                copy_row_raw(orow, src, ix1 - ix0, comps * sample_bytes,
                             sample_bytes);
              else
                copy_row((float*)orow, src, ix1 - ix0, comps * sample_bytes);
            }
          }
        }
      };
      if (nthreads <= 1) {
        worker();
      } else {
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < nthreads; ++t) ts.emplace_back(worker);
        for (auto& t : ts) t.join();
      }
      if (failed.load()) {
        err.set("tile decode failed");
        return false;
      }
      return true;
    }

    // striped
    uint64_t s0 = (uint64_t)y0 / rows_per_strip;
    uint64_t s1 = (uint64_t)(y0 + win_h - 1) / rows_per_strip;
    uint64_t nstrips = strips_count();
    std::vector<uint8_t> buf;
    for (uint64_t s = s0; s <= s1; ++s) {
      uint64_t srow0 = s * rows_per_strip;
      uint64_t srows = std::min(rows_per_strip, height - srow0);
      for (int pl = 0; pl < (planar == 2 ? nbands : 1); ++pl) {
        uint64_t idx = planar == 2 ? (uint64_t)(bands[pl] - 1) * nstrips + s : s;
        if (!decode_chunk(idx, buf, srows, width, comps)) {
          err.set("strip decode failed");
          return false;
        }
        int64_t iy0 = std::max(y0, (int64_t)srow0);
        int64_t iy1 = std::min(y0 + win_h, (int64_t)(srow0 + srows));
        for (int64_t y = iy0; y < iy1; ++y) {
          const uint8_t* row =
              buf.data() + ((size_t)(y - (int64_t)srow0) * width) * comps * sample_bytes;
          for (int b = 0; b < nbands; ++b) {
            if (planar == 2 && pl != b) continue;
            int comp = planar == 1 ? bands[b] - 1 : 0;
            size_t osb = raw ? sample_bytes : 4;
            uint8_t* orow = out + ((size_t)b * win_h + (y - y0)) * win_w * osb;
            const uint8_t* src = row + ((size_t)x0 * comps + comp) * sample_bytes;
            if (raw)
              copy_row_raw(orow, src, win_w, comps * sample_bytes, sample_bytes);
            else
              copy_row((float*)orow, src, win_w, comps * sample_bytes);
          }
        }
      }
    }
    return true;
  }
};

// ------------------------------------------------------------------- writer

struct Writer {
  FILE* f = nullptr;
  std::string path;
  uint64_t width = 0, height = 0;
  int bands = 1;
  int dtype = DT_F32;
  uint64_t tile = 256;
  bool big = false;
  int zlevel = 1;
  std::map<uint16_t, TagEntry> geo_tags;
  std::string nodata_str;

  std::vector<uint64_t> tile_offsets;
  std::vector<uint64_t> tile_counts;
  uint64_t cur_off = 0;

  ~Writer() {
    if (f) fclose(f);
  }

  uint64_t ntx() const { return (width + tile - 1) / tile; }
  uint64_t nty() const { return (height + tile - 1) / tile; }

  bool create(const char* p, uint64_t w, uint64_t h, int nb, int dt, Err& err) {
    path = p;
    width = w;
    height = h;
    bands = nb;
    dtype = dt;
    uint64_t raw = w * h * (uint64_t)nb * dtype_size(dt);
    big = raw > 3500000000ULL;  // BigTIFF IF_SAFER semantics
    f = fopen(p, "wb");
    if (!f) {
      err.set(std::string("cannot create ") + p);
      return false;
    }
    // header; IFD written at finish (offset patched)
    if (big) {
      const uint8_t hdr[16] = {'I', 'I', 43, 0, 8, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
      fwrite(hdr, 1, 16, f);
      cur_off = 16;
    } else {
      const uint8_t hdr[8] = {'I', 'I', 42, 0, 0, 0, 0, 0};
      fwrite(hdr, 1, 8, f);
      cur_off = 8;
    }
    tile_offsets.assign(ntx() * nty(), 0);
    tile_counts.assign(ntx() * nty(), 0);
    return true;
  }

  // gather one tile (pad edges with 0) from the float32 image into raw,
  // converting to the target dtype per pixel
  void gather_tile(const float* data, uint64_t ty, uint64_t tx,
                   std::vector<uint8_t>& raw) const {
    size_t sb = dtype_size(dtype);
    memset(raw.data(), 0, raw.size());
    uint64_t y1 = std::min(height, (ty + 1) * tile);
    uint64_t x1 = std::min(width, (tx + 1) * tile);
    for (uint64_t y = ty * tile; y < y1; ++y) {
      for (int b = 0; b < bands; ++b) {
        const float* src = data + ((size_t)b * height + y) * width + tx * tile;
        uint8_t* dst =
            raw.data() +
            (((y - ty * tile) * tile) * bands + b) * sb;
        for (uint64_t x = tx * tile; x < x1; ++x) {
          float v = *src++;
          switch (dtype) {
            case DT_U8: *dst = (uint8_t)v; break;
            case DT_U16: { uint16_t q = (uint16_t)v; memcpy(dst, &q, 2); break; }
            case DT_I16: { int16_t q = (int16_t)v; memcpy(dst, &q, 2); break; }
            case DT_I32: { int32_t q = (int32_t)v; memcpy(dst, &q, 4); break; }
            case DT_F32: memcpy(dst, &v, 4); break;
            case DT_F64: { double q = v; memcpy(dst, &q, 8); break; }
            default: break;
          }
          dst += bands * sb;
        }
      }
    }
  }

  // write one full band-interleaved image from a float32 buffer
  // data layout: [bands][height][width] (converted to target dtype per pixel)
  //
  // Tile gather+deflate runs on a thread pool in bounded blocks (the
  // decode path is threaded too, :759-801). Tiles land on disk in the
  // identical ty-major order with identical compress2 output, so the
  // file is byte-for-byte the single-threaded result.
  bool write_data(const float* data, Err& err) {
    size_t sb = dtype_size(dtype);
    const uint64_t NTX = ntx(), NTY = nty();
    const uint64_t ntiles = NTX * NTY;
    unsigned nthreads = std::min<unsigned>(
        std::max(1u, std::thread::hardware_concurrency()), 16u);
    // override (tests pin threaded-vs-sequential byte identity on 1-core
    // hosts; operators can cap encoder threads on shared machines)
    if (const char* ov = getenv("POPCORN_GT_WRITE_THREADS")) {
      long v = atol(ov);
      if (v >= 1) nthreads = (unsigned)std::min<long>(v, 64);
    }
    nthreads = std::min<unsigned>(nthreads, (unsigned)ntiles);

    if (nthreads <= 1) {
      std::vector<uint8_t> raw(tile * tile * bands * sb);
      std::vector<uint8_t> comp(compressBound((uLong)raw.size()));
      for (uint64_t t = 0; t < ntiles; ++t) {
        gather_tile(data, t / NTX, t % NTX, raw);
        uLongf clen = (uLongf)comp.size();
        if (compress2(comp.data(), &clen, raw.data(), (uLong)raw.size(),
                      zlevel) != Z_OK) {
          err.set("deflate failed");
          return false;
        }
        tile_offsets[t] = cur_off;
        tile_counts[t] = clen;
        fwrite(comp.data(), 1, clen, f);
        cur_off += clen;
      }
      return true;
    }

    // block-parallel encode: compress `block` tiles concurrently, then
    // the main thread streams them out in order — bounded memory
    // (block x compressed-tile), deterministic layout
    const uint64_t block = (uint64_t)nthreads * 4;
    std::vector<std::vector<uint8_t>> comp(block);
    std::vector<uLongf> clens(block, 0);
    std::atomic<bool> failed{false};
    for (uint64_t start = 0; start < ntiles; start += block) {
      const uint64_t cnt = std::min(block, ntiles - start);
      std::atomic<uint64_t> next{0};
      auto worker = [&]() {
        std::vector<uint8_t> raw(tile * tile * bands * sb);
        while (!failed.load()) {
          uint64_t k = next.fetch_add(1);
          if (k >= cnt) break;
          uint64_t t = start + k;
          gather_tile(data, t / NTX, t % NTX, raw);
          comp[k].resize(compressBound((uLong)raw.size()));
          uLongf clen = (uLongf)comp[k].size();
          if (compress2(comp[k].data(), &clen, raw.data(),
                        (uLong)raw.size(), zlevel) != Z_OK) {
            failed.store(true);
            break;
          }
          clens[k] = clen;
        }
      };
      unsigned nt = std::min<unsigned>(nthreads, (unsigned)cnt);
      std::vector<std::thread> ts;
      for (unsigned i = 0; i < nt; ++i) ts.emplace_back(worker);
      for (auto& th : ts) th.join();
      if (failed.load()) {
        err.set("deflate failed");
        return false;
      }
      for (uint64_t k = 0; k < cnt; ++k) {
        uint64_t t = start + k;
        tile_offsets[t] = cur_off;
        tile_counts[t] = clens[k];
        fwrite(comp[k].data(), 1, clens[k], f);
        cur_off += clens[k];
      }
    }
    return true;
  }

  void put_tag(std::vector<uint8_t>& ifd, std::vector<uint8_t>& extra,
               uint64_t extra_base, uint16_t tag, uint16_t type,
               uint64_t count, const void* values) {
    size_t vlen = count * type_size(type);
    size_t inline_cap = big ? 8 : 4;
    uint8_t entry[20] = {0};
    memcpy(entry, &tag, 2);
    memcpy(entry + 2, &type, 2);
    if (big) {
      memcpy(entry + 4, &count, 8);
      if (vlen <= inline_cap) {
        memcpy(entry + 12, values, vlen);
      } else {
        uint64_t off = extra_base + extra.size();
        memcpy(entry + 12, &off, 8);
        extra.insert(extra.end(), (const uint8_t*)values, (const uint8_t*)values + vlen);
        if (extra.size() & 1) extra.push_back(0);
      }
      ifd.insert(ifd.end(), entry, entry + 20);
    } else {
      uint32_t c32 = (uint32_t)count;
      memcpy(entry + 4, &c32, 4);
      if (vlen <= inline_cap) {
        memcpy(entry + 8, values, vlen);
      } else {
        uint32_t off = (uint32_t)(extra_base + extra.size());
        memcpy(entry + 8, &off, 4);
        extra.insert(extra.end(), (const uint8_t*)values, (const uint8_t*)values + vlen);
        if (extra.size() & 1) extra.push_back(0);
      }
      ifd.insert(ifd.end(), entry, entry + 12);
    }
  }

  bool finish(Err& err) {
    // assemble IFD
    struct TagDef { uint16_t tag; uint16_t type; uint64_t count; std::vector<uint8_t> val; };
    std::vector<TagDef> tags;
    auto add_u = [&](uint16_t tag, uint16_t type, std::vector<uint64_t> vals) {
      TagDef d{tag, type, (uint64_t)vals.size(), {}};
      size_t ts = type_size(type);
      d.val.resize(vals.size() * ts);
      for (size_t i = 0; i < vals.size(); ++i) {
        if (type == T_SHORT) { uint16_t v = (uint16_t)vals[i]; memcpy(d.val.data() + i * 2, &v, 2); }
        else if (type == T_LONG) { uint32_t v = (uint32_t)vals[i]; memcpy(d.val.data() + i * 4, &v, 4); }
        else { uint64_t v = vals[i]; memcpy(d.val.data() + i * 8, &v, 8); }
      }
      tags.push_back(std::move(d));
    };

    uint16_t sf;
    uint16_t bitsv;
    switch (dtype) {
      case DT_U8: sf = 1; bitsv = 8; break;
      case DT_U16: sf = 1; bitsv = 16; break;
      case DT_I16: sf = 2; bitsv = 16; break;
      case DT_I32: sf = 2; bitsv = 32; break;
      case DT_F64: sf = 3; bitsv = 64; break;
      case DT_F32: default: sf = 3; bitsv = 32; break;
    }

    add_u(TAG_WIDTH, T_LONG, {width});
    add_u(TAG_HEIGHT, T_LONG, {height});
    add_u(TAG_BITS, T_SHORT, std::vector<uint64_t>(bands, bitsv));
    add_u(TAG_COMPRESSION, T_SHORT, {8});
    add_u(TAG_PHOTOMETRIC, T_SHORT, {1});
    add_u(TAG_SPP, T_SHORT, {(uint64_t)bands});
    add_u(TAG_PLANARCONFIG, T_SHORT, {1});
    add_u(TAG_SAMPLEFORMAT, T_SHORT, std::vector<uint64_t>(bands, sf));
    add_u(TAG_TILE_WIDTH, T_LONG, {tile});
    add_u(TAG_TILE_HEIGHT, T_LONG, {tile});
    uint16_t off_type = big ? T_LONG8 : T_LONG;
    add_u(TAG_TILE_OFFSETS, off_type, tile_offsets);
    add_u(TAG_TILE_BYTECOUNTS, off_type, tile_counts);
    for (auto& kv : geo_tags) {
      TagDef d{kv.first, kv.second.type, kv.second.count, kv.second.data};
      tags.push_back(std::move(d));
    }
    if (!nodata_str.empty()) {
      TagDef d{TAG_GDAL_NODATA, T_ASCII, nodata_str.size() + 1, {}};
      d.val.assign(nodata_str.begin(), nodata_str.end());
      d.val.push_back(0);
      tags.push_back(std::move(d));
    }
    std::sort(tags.begin(), tags.end(),
              [](const TagDef& a, const TagDef& b) { return a.tag < b.tag; });

    uint64_t ifd_off = cur_off;
    if (ifd_off & 1) {  // word-align
      fputc(0, f);
      ifd_off = ++cur_off;
    }
    size_t esz = big ? 20 : 12;
    uint64_t header_len = (big ? 8 : 2) + tags.size() * esz + (big ? 8 : 4);
    uint64_t extra_base = ifd_off + header_len;

    std::vector<uint8_t> ifd;
    std::vector<uint8_t> extra;
    for (auto& t : tags) put_tag(ifd, extra, extra_base, t.tag, t.type, t.count, t.val.data());

    // write IFD
    fseeko(f, (off_t)ifd_off, SEEK_SET);
    if (big) {
      uint64_t n = tags.size();
      fwrite(&n, 8, 1, f);
    } else {
      uint16_t n = (uint16_t)tags.size();
      fwrite(&n, 2, 1, f);
    }
    fwrite(ifd.data(), 1, ifd.size(), f);
    uint64_t zero = 0;
    fwrite(&zero, 1, big ? 8 : 4, f);
    fwrite(extra.data(), 1, extra.size(), f);

    // patch header IFD offset
    fseeko(f, big ? 8 : 4, SEEK_SET);
    if (big) fwrite(&ifd_off, 8, 1, f);
    else {
      uint32_t o = (uint32_t)ifd_off;
      fwrite(&o, 4, 1, f);
    }
    fclose(f);
    f = nullptr;
    return true;
  }
};

}  // namespace

// =============================================================== C ABI

extern "C" {

void* gt_open(const char* path, char* errbuf, int errlen) {
  Err err{errbuf, errlen};
  auto* r = new Reader();
  if (!r->open(path, err)) {
    delete r;
    return nullptr;
  }
  return r;
}

// Tile-level NaN presence over a contiguous float32 (bands, h, w) array:
// out[ty][tx] = 1 when any sample of any band in that tile is NaN.
// One streaming pass replaces the numpy detour the mosaic feeds used
// (isnan -> (C,H,W) bool temp -> any(axis=0) -> block pooling): ~5x
// faster at country-season size and allocation-free, so a loaded 1-core
// host pays one read pass.
int gt_nan_tile_any(const float* a, long long bands, long long h,
                    long long w, int tile, unsigned char* out) {
  if (tile <= 0 || bands < 0 || h < 0 || w < 0) return 1;
  long long th = (h + tile - 1) / tile, tw = (w + tile - 1) / tile;
  memset(out, 0, (size_t)(th * tw));
  for (long long b = 0; b < bands; ++b) {
    const float* plane = a + (size_t)b * h * w;
    for (long long y = 0; y < h; ++y) {
      unsigned char* orow = out + (size_t)(y / tile) * tw;
      const float* row = plane + (size_t)y * w;
      for (long long t = 0; t < tw; ++t) {
        if (orow[t]) continue;  // tile already flagged: skip the scan
        long long x0 = t * tile;
        long long x1 = x0 + tile < w ? x0 + tile : w;
        int any = 0;
        for (long long x = x0; x < x1; ++x) any |= (row[x] != row[x]);
        orow[t] = (unsigned char)any;
      }
    }
  }
  return 0;
}

// Streaming "does this float32 buffer contain any NaN" (layout-agnostic:
// callers pass the flat sample count). Early-exits on the first NaN
// block so healed-data checks on clean arrays pay one read pass and
// dirty arrays pay even less.
int gt_has_nan_f32(const float* a, long long n) {
  const long long BLK = 1 << 16;
  for (long long i = 0; i < n; i += BLK) {
    long long e = i + BLK < n ? i + BLK : n;
    int any = 0;
    for (long long j = i; j < e; ++j) any |= (a[j] != a[j]);
    if (any) return 1;
  }
  return 0;
}

void gt_close(void* h) { delete (Reader*)h; }

long long gt_width(void* h) { return (long long)((Reader*)h)->width; }
long long gt_height(void* h) { return (long long)((Reader*)h)->height; }
int gt_bands(void* h) { return (int)((Reader*)h)->spp; }
int gt_dtype(void* h) { return ((Reader*)h)->dtype; }

int gt_nodata(void* h, double* out) {
  Reader* r = (Reader*)h;
  *out = r->nodata;
  return r->has_nodata ? 1 : 0;
}

// GDAL-style geotransform [origin_x, px_w, 0, origin_y, 0, px_h(-)].
// Returns 1 if geo info present.
int gt_transform(void* h, double* out6) {
  Reader* r = (Reader*)h;
  auto it_t = r->geo_tags.find(TAG_MODEL_TRANSFORMATION);
  if (it_t != r->geo_tags.end()) {
    auto m = it_t->second.as_doubles();
    if (m.size() >= 8) {
      out6[0] = m[3]; out6[1] = m[0]; out6[2] = m[1];
      out6[3] = m[7]; out6[4] = m[4]; out6[5] = m[5];
      return 1;
    }
  }
  auto it_s = r->geo_tags.find(TAG_MODEL_PIXEL_SCALE);
  auto it_p = r->geo_tags.find(TAG_MODEL_TIEPOINT);
  if (it_s != r->geo_tags.end() && it_p != r->geo_tags.end()) {
    auto s = it_s->second.as_doubles();
    auto p = it_p->second.as_doubles();
    if (s.size() >= 2 && p.size() >= 6) {
      out6[0] = p[3] - p[0] * s[0];
      out6[1] = s[0];
      out6[2] = 0;
      out6[3] = p[4] + p[1] * s[1];
      out6[4] = 0;
      out6[5] = -s[1];
      return 1;
    }
  }
  return 0;
}

int gt_read_window(void* h, const int* bands, int nbands, long long x0,
                   long long y0, long long w, long long hh, float* out,
                   char* errbuf, int errlen) {
  Err err{errbuf, errlen};
  Reader* r = (Reader*)h;
  return r->read_window(bands, nbands, x0, y0, w, hh, (uint8_t*)out,
                        /*raw=*/false, err)
             ? 0
             : 1;
}

// Raw windowed read: `out` receives the file's native dtype (gt_dtype),
// no float conversion — half the memory traffic for uint16 mosaics.
int gt_read_window_raw(void* h, const int* bands, int nbands, long long x0,
                       long long y0, long long w, long long hh, void* out,
                       char* errbuf, int errlen) {
  Err err{errbuf, errlen};
  Reader* r = (Reader*)h;
  return r->read_window(bands, nbands, x0, y0, w, hh, (uint8_t*)out,
                        /*raw=*/true, err)
             ? 0
             : 1;
}

void* gtw_create(const char* path, long long w, long long h, int bands,
                 int dtype, int tile, char* errbuf, int errlen) {
  Err err{errbuf, errlen};
  auto* wr = new Writer();
  if (tile > 0) wr->tile = (uint64_t)tile;
  if (!wr->create(path, (uint64_t)w, (uint64_t)h, bands, dtype, err)) {
    delete wr;
    return nullptr;
  }
  return wr;
}

// copy geo tags (pixel scale, tiepoint, geokeys, etc.) from an open reader
int gtw_copy_geo(void* hw, void* hr) {
  Writer* w = (Writer*)hw;
  Reader* r = (Reader*)hr;
  for (auto& kv : r->geo_tags) {
    if (kv.first == TAG_GDAL_NODATA) continue;  // set explicitly
    w->geo_tags[kv.first] = kv.second;
  }
  return 0;
}

// set geotransform directly (north-up): origin_x, px_w, origin_y, px_h(>0)
int gtw_set_transform(void* hw, double origin_x, double px_w, double origin_y,
                      double px_h) {
  Writer* w = (Writer*)hw;
  TagEntry scale;
  scale.tag = TAG_MODEL_PIXEL_SCALE;
  scale.type = T_DOUBLE;
  scale.count = 3;
  double sv[3] = {px_w, px_h, 0.0};
  scale.data.resize(24);
  memcpy(scale.data.data(), sv, 24);
  w->geo_tags[scale.tag] = scale;

  TagEntry tie;
  tie.tag = TAG_MODEL_TIEPOINT;
  tie.type = T_DOUBLE;
  tie.count = 6;
  double tv[6] = {0, 0, 0, origin_x, origin_y, 0};
  tie.data.resize(48);
  memcpy(tie.data.data(), tv, 48);
  w->geo_tags[tie.tag] = tie;
  return 0;
}

int gtw_set_nodata(void* hw, double nodata) {
  char buf[64];
  snprintf(buf, sizeof(buf), "%g", nodata);
  ((Writer*)hw)->nodata_str = buf;
  return 0;
}

int gtw_set_zlevel(void* hw, int level) {
  ((Writer*)hw)->zlevel = level;
  return 0;
}

int gtw_write(void* hw, const float* data, char* errbuf, int errlen) {
  Err err{errbuf, errlen};
  return ((Writer*)hw)->write_data(data, err) ? 0 : 1;
}

int gtw_finish(void* hw, char* errbuf, int errlen) {
  Err err{errbuf, errlen};
  Writer* w = (Writer*)hw;
  bool ok = w->finish(err);
  delete w;
  return ok ? 0 : 1;
}

void gtw_abort(void* hw) { delete (Writer*)hw; }

}  // extern "C"
