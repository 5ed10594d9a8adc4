// The port's .key text writer and reader: host code, not a kernel.
//
// The reference's text format (writer msFeature3DVectorOutputText, reader
// msFeature3DVectorInputText, src_common/MultiScale.h:305-474), written and
// parsed in C for the 81-field rows a featextract or featmatch call moves.
// It is the port's own copy of the JAX package's native runtime, with the
// same three C entries and the same bytes; sift3d_torch/io/native.py builds
// it with g++ at first use and binds it with ctypes, and
// sift3d_torch/io/keyfile.py's pure-Python writer and reader are its plain
// version.
//
// Build flags (io/native.py): -O3 -fPIC -shared -ffp-contract=off. The
// write-time eigenvalue filter s * s * s < thres * p must round as
// FeatureSet.eig_mask's numpy expression does, each product on its own, so
// no multiply may be contracted into another operation.
//
// Floats print as glibc's "%f" prints them, through put_f: for a finite f32 v
// with |v| < 1e12, the double product |v| * 1e6 is exact (24 + 20 bits) and
// nearbyint rounds it half to even, as glibc's "%f" rounds the exact decimal,
// so the integer's digits are the printed digits; NaN, infinities and larger
// values go through snprintf. The bytes equal snprintf's on every f32
// (tests/test_torch_native_io.py holds them against the JAX package's
// snprintf writer on ties, signed zeros, small negatives, non-finite values
// and random bit patterns over the whole f32 range).
//
// Line length: a row prints 16 floats with %f, one unsigned info and 64
// wrapped descriptor values. The longest f32 (-3.4028235e38) prints as 47
// characters, so 16 * 48 + 11 ("4294967295\t") + 64 * 5 ("-128\t") + 1
// ("\n") = 1100 bytes at most, well inside the 4096-byte line buffer; a
// reader line is at most that long, inside its 16384-byte buffer.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// The decimal digits of u at p; returns their count.
int put_u64(char *p, uint64_t u) {
  char tmp[20];
  int k = 0;
  do {
    tmp[k++] = (char)('0' + u % 10);
    u /= 10;
  } while (u);
  for (int j = 0; j < k; j++) p[j] = tmp[k - 1 - j];
  return k;
}

// "%i" of a descriptor value at p; returns the characters written.
int put_i(char *p, int v) {
  if (v < 0) {
    p[0] = '-';
    return 1 + put_u64(p + 1, (uint64_t)(-(long long)v));
  }
  return put_u64(p, (uint64_t)v);
}

// glibc's "%f" of v at p, in a buffer of `room` bytes; returns the characters
// written (see the head of this file).
int put_f(char *p, size_t room, float v) {
  if (!(std::fabs(v) < 1e12f)) return snprintf(p, room, "%f", v);
  const uint64_t u = (uint64_t)std::nearbyint(std::fabs((double)v) * 1e6);
  int o = 0;
  if (std::signbit(v)) p[o++] = '-';
  o += put_u64(p + o, u / 1000000);
  p[o++] = '.';
  uint64_t frac = u % 1000000;
  for (int k = 5; k >= 0; k--) {
    p[o + k] = (char)('0' + frac % 10);
    frac /= 10;
  }
  return o + 6;
}

// Python's "%f" of v: put_f's, but a NaN prints "nan" whatever its sign.
int put_py_f(char *p, size_t room, float v) {
  if (std::isnan(v)) {
    memcpy(p, "nan", 3);
    return 3;
  }
  return put_f(p, room, v);
}

// "%N.Nd" of a non-negative v (at least `digits` digits, zero-padded) at p.
int put_padded(char *p, long long v, int digits) {
  char tmp[24];
  const int k = put_u64(tmp, (uint64_t)v);
  int o = 0;
  for (; o < digits - k; o++) p[o] = '0';
  memcpy(p + o, tmp, k);
  return o + k;
}

// strtof(p, end), taking a shortcut for the tokens "%f" and "%i" print:
// [+-]digits[.digits] with at most 15 digits, 6 of them after the point.
// Such a token is N / 10^F exactly (N < 2^53, F <= 6), and the double
// quotient rounds once to within 2^-53 of it; an f32 midpoint other than
// the value itself lies at least 2^-24 / 10^6 > 2^-44 (relative) from any
// such decimal, so rounding the double to f32 rounds the decimal once, as
// strtof does, ties (the value on a midpoint) to even alike. Anything else
// (exponents, hex, inf, nan, longer tokens) goes to strtof.
float parse_f(const char *p, char **end) {
  const char *q = p;
  while (*q == ' ' || *q == '\t' || *q == '\n' || *q == '\r' || *q == '\f' || *q == '\v') q++;
  const bool neg = *q == '-';
  if (*q == '-' || *q == '+') q++;
  uint64_t n = 0;
  int digits = 0, frac = 0;
  for (; *q >= '0' && *q <= '9'; q++, digits++) n = n * 10 + (uint64_t)(*q - '0');
  if (*q == '.') {
    for (q++; *q >= '0' && *q <= '9'; q++, digits++, frac++) n = n * 10 + (uint64_t)(*q - '0');
  }
  const char c = *q;
  if (digits == 0 || digits > 15 || frac > 6 || c == 'e' || c == 'E' || c == 'x' || c == 'X' || c == 'p' ||
      c == 'P') {
    return strtof(p, end);
  }
  static const double kPow10[7] = {1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6};
  const float v = (float)((double)n / kPow10[frac]);
  *end = (char *)q;
  return neg ? -v : v;
}

}  // namespace

extern "C" {

// Write the text format. Returns the number of features written, or -1 when
// the file cannot be opened. xyz [n,3], scale [n], ori [n,9], eigs [n,3],
// info [n], desc [n,64]; eig_thres < 0 keeps every row.
int s3d_write_key_text(const char *path, int n, const float *xyz, const float *scale, const float *ori,
                       const float *eigs, const uint32_t *info, const float *desc, int n_comments,
                       const char **comments, float eig_thres) {
  FILE *f = fopen(path, "wt");
  if (!f) return -1;

  // the edge-response keep rule (MultiScale.h:407-414)
  std::vector<int> keep;
  keep.reserve(n);
  for (int i = 0; i < n; i++) {
    if (eig_thres < 0) {
      keep.push_back(i);
      continue;
    }
    const float *e = eigs + 3 * i;
    float s = e[0] + e[1] + e[2];
    float p = e[0] * e[1] * e[2];
    if (s * s * s < eig_thres * p) keep.push_back(i);
  }

  fprintf(f, "# featExtract 1.1\n");
  for (int c = 0; c < n_comments; c++) fprintf(f, "# %s\n", comments[c]);
  fprintf(f, "Features: %d\n", (int)keep.size());
  fprintf(f,
          "Scale-space location[x y z scale] orientation[o11 o12 o13 o21 o22 "
          "o23 o31 o32 o32] 2nd moment eigenvalues[e1 e2 e3] info flag[i1] "
          "descriptor[d1 .. d64]\n");

  char line[4096];
  for (int ki = 0; ki < (int)keep.size(); ki++) {
    int i = keep[ki];
    const float v[16] = {xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2], scale[i],
                         ori[9 * i], ori[9 * i + 1], ori[9 * i + 2], ori[9 * i + 3], ori[9 * i + 4],
                         ori[9 * i + 5], ori[9 * i + 6], ori[9 * i + 7], ori[9 * i + 8],
                         eigs[3 * i], eigs[3 * i + 1], eigs[3 * i + 2]};
    int o = 0;
    for (int j = 0; j < 16; j++) {
      o += put_f(line + o, sizeof(line) - o, v[j]);
      line[o++] = '\t';
    }
    o += put_u64(line + o, info[i]);
    line[o++] = '\t';
    for (int j = 0; j < 64; j++) {
      // (char) cast of the float value (MultiScale.h:467): truncate toward
      // zero, then wrap to signed 8 bits
      o += put_i(line + o, (int)(char)(long long)desc[64 * i + j]);
      line[o++] = '\t';
    }
    line[o++] = '\n';
    fwrite(line, 1, o, f);
  }
  fclose(f);
  return (int)keep.size();
}

// The declared feature count of a .key text file (the first line that is not
// a comment, "Features: N"), or -1 when the file cannot be opened or that
// line is not a count.
int s3d_key_count(const char *path) {
  FILE *f = fopen(path, "rt");
  if (!f) return -1;
  char buf[8192];
  int count = -1;
  while (fgets(buf, sizeof(buf), f)) {
    if (buf[0] == '#') continue;
    if (sscanf(buf, "Features: %d", &count) == 1) break;
    break;
  }
  fclose(f);
  return count;
}

// Read up to n rows into arrays the caller sized by s3d_key_count. Parsing
// stops at the first row that does not hold 16 floats, an info and 64
// descriptor values (a truncated file gives the rows before it). Floats are
// parsed as strtof parses them (parse_f), each decimal rounded to f32 once. Returns the
// number of rows read, or -1 when the file cannot be opened or its header
// is not the format's.
int s3d_read_key_text(const char *path, int n, float *xyz, float *scale, float *ori, float *eigs, uint32_t *info,
                      float *desc) {
  FILE *f = fopen(path, "rt");
  if (!f) return -1;
  char buf[16384];
  // comments, then the count line, then the legend
  int declared = -1;
  while (fgets(buf, sizeof(buf), f)) {
    if (buf[0] == '#') continue;
    if (sscanf(buf, "Features: %d", &declared) == 1) break;
    fclose(f);
    return -1;
  }
  if (!fgets(buf, sizeof(buf), f)) {
    fclose(f);
    return -1;
  }
  if (!strstr(buf, "Scale-space location[x y z scale]")) {
    fclose(f);
    return -1;
  }

  int rows = 0;
  while (rows < n && fgets(buf, sizeof(buf), f)) {
    char *p = buf;
    char *end;
    // x y z scale, 9 orientation values, 3 eigenvalues
    float vals[16];
    bool ok = true;
    for (int j = 0; j < 16; j++) {
      vals[j] = parse_f(p, &end);
      if (end == p) {
        ok = false;
        break;
      }
      p = end;
    }
    if (!ok) break;
    xyz[3 * rows] = vals[0];
    xyz[3 * rows + 1] = vals[1];
    xyz[3 * rows + 2] = vals[2];
    scale[rows] = vals[3];
    memcpy(ori + 9 * rows, vals + 4, 9 * sizeof(float));
    memcpy(eigs + 3 * rows, vals + 13, 3 * sizeof(float));
    info[rows] = (uint32_t)strtoul(p, &end, 10);
    if (end == p) break;
    p = end;
    for (int j = 0; j < 64; j++) {
      desc[64 * rows + j] = parse_f(p, &end);
      if (end == p) {
        ok = false;
        break;
      }
      p = end;
    }
    if (!ok) break;
    rows++;
  }
  fclose(f);
  return rows;
}

// Write one featmatch match file (featMatchMultiple.cpp:303-318): the
// header text as given, then per match m one line
// "name\tx\ty\tz\ts\timg2_match%4.4d_feat%6.6d\t0.000000\to11 .. o33\n" with
// the other image's row other[m]. xyz [n,3], scale [n], ori [n,9]. The
// floats print as the JAX package's CLI prints them (Python's "%f"), which
// is put_f's but for a NaN, printed "nan" whatever its sign. Returns n, or
// -1 when the file cannot be opened.
int s3d_write_match_text(const char *path, const char *header, const char *name, int n, const float *xyz,
                         const float *scale, const float *ori, const int64_t *other) {
  FILE *f = fopen(path, "wt");
  if (!f) return -1;
  fputs(header, f);
  const size_t name_len = strlen(name);
  std::vector<char> line(name_len + 1024);
  for (int m = 0; m < n; m++) {
    char *p = line.data();
    const size_t room = line.size();
    memcpy(p, name, name_len);
    int o = (int)name_len;
    const float geom[4] = {xyz[3 * m], xyz[3 * m + 1], xyz[3 * m + 2], scale[m]};
    for (int j = 0; j < 4; j++) {
      p[o++] = '\t';
      o += put_py_f(p + o, room - o, geom[j]);
    }
    memcpy(p + o, "\timg2_match", 11);
    o += 11;
    o += put_padded(p + o, m, 4);
    memcpy(p + o, "_feat", 5);
    o += 5;
    o += put_padded(p + o, other[m], 6);
    memcpy(p + o, "\t0.000000", 9);
    o += 9;
    for (int j = 0; j < 9; j++) {
      p[o++] = '\t';
      o += put_py_f(p + o, room - o, ori[9 * m + j]);
    }
    p[o++] = '\n';
    fwrite(p, 1, o, f);
  }
  fclose(f);
  return n;
}

}  // extern "C"
