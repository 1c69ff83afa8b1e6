/* fastio: the SNP reader's line parser and the ms haplotype matrix, in C.
 *
 * The counterpart of fscl_tpu/native/fastio.c with a plain C interface in
 * place of the CPython one: no Python.h, so the host's C compiler builds it
 * with no development headers (fastio.py builds it at first use and loads
 * it with ctypes).  The line grammar is fscl_tpu's, unchanged:
 *
 *   leading spaces and tabs skipped; a line then empty or starting with
 *   '#' is skipped; the chromosome token runs to the next isspace
 *   character; then four strtoll(..., 10) fields with no check of what
 *   follows each.  A row whose token or any field fails is skipped
 *   without a word; values saturate as strtoll does.
 *
 * So it reads some malformed lines otherwise than the reader's Python loop
 * does ("4x" is 4, "1_3" no number, an overflow saturates): the same
 * lines, the same way, as fscl_tpu's C parser.  Filtering and folding stay
 * in Python, where the policy flags live.
 *
 * Chromosome names come back once each, in order of first appearance,
 * with a code a row; a row is compared with the previous row's name
 * first, so a run of one chromosome costs no hash lookup.
 */

#define _POSIX_C_SOURCE 200809L

#include <ctype.h>
#include <errno.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/types.h>

/* What fscl_parse_snp_file fills; fscl_free releases it.  Mirrored by
   fastio.py's _Rows. */
typedef struct {
  int64_t n_rows;
  int64_t *pos, *freq, *size, *folded;
  int32_t *chr;       /* a row's chromosome code */
  int64_t n_chr;      /* distinct names, codes 0 .. n_chr - 1 */
  int64_t *name_off;  /* [n_chr + 1]: name c is names[off[c] .. off[c+1]) */
  char *names;        /* the names, concatenated, not NUL-terminated */
} fscl_snp_rows;

typedef struct {
  fscl_snp_rows *t;
  size_t rows_cap, names_len, names_cap, offs_cap;
  int32_t *slots; /* open addressing over the codes; -1 is empty */
  size_t n_slots;
} accumulator;

static int resize(void **p, size_t bytes) {
  void *np = realloc(*p, bytes);
  if (!np) return -1;
  *p = np;
  return 0;
}

/* *p to room for need elements, doubling from 4096 */
static int grow(void **p, size_t *cap, size_t need, size_t elem) {
  if (need <= *cap) return 0;
  size_t ncap = *cap ? *cap : 4096;
  while (ncap < need) ncap *= 2;
  if (resize(p, ncap * elem)) return -1;
  *cap = ncap;
  return 0;
}

static int push_row(accumulator *b, int64_t pos, int64_t freq, int64_t size,
                    int64_t fold, int32_t code) {
  fscl_snp_rows *t = b->t;
  size_t n = (size_t)t->n_rows;
  if (n == b->rows_cap) {
    size_t ncap = n ? 2 * n : 65536;
    if (resize((void **)&t->pos, ncap * 8) ||
        resize((void **)&t->freq, ncap * 8) ||
        resize((void **)&t->size, ncap * 8) ||
        resize((void **)&t->folded, ncap * 8) ||
        resize((void **)&t->chr, ncap * 4))
      return -1;
    b->rows_cap = ncap;
  }
  t->pos[n] = pos;
  t->freq[n] = freq;
  t->size[n] = size;
  t->folded[n] = fold;
  t->chr[n] = code;
  t->n_rows++;
  return 0;
}

static uint64_t hash(const char *s, size_t n) { /* FNV-1a */
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; i++) {
    h ^= (unsigned char)s[i];
    h *= 1099511628211ULL;
  }
  return h;
}

static int same_name(const fscl_snp_rows *t, int32_t c, const char *s,
                     size_t n) {
  size_t len = (size_t)(t->name_off[c + 1] - t->name_off[c]);
  return len == n && memcmp(t->names + t->name_off[c], s, n) == 0;
}

static void place(accumulator *b, int32_t c) {
  const fscl_snp_rows *t = b->t;
  size_t mask = b->n_slots - 1;
  size_t i = (size_t)hash(t->names + t->name_off[c],
                          (size_t)(t->name_off[c + 1] - t->name_off[c])) &
             mask;
  while (b->slots[i] >= 0) i = (i + 1) & mask;
  b->slots[i] = c;
}

/* The code of name s[0 .. n), added if new; -1 when out of memory. */
static int32_t name_code(accumulator *b, const char *s, size_t n) {
  fscl_snp_rows *t = b->t;
  if (b->n_slots) {
    size_t mask = b->n_slots - 1;
    for (size_t i = (size_t)hash(s, n) & mask; b->slots[i] >= 0;
         i = (i + 1) & mask)
      if (same_name(t, b->slots[i], s, n)) return b->slots[i];
  }
  if ((size_t)(t->n_chr + 1) * 2 > b->n_slots) { /* rehash at half full */
    size_t ns = b->n_slots ? b->n_slots * 2 : 64;
    int32_t *slots = malloc(ns * sizeof *slots);
    if (!slots) return -1;
    free(b->slots);
    b->slots = slots;
    b->n_slots = ns;
    for (size_t i = 0; i < ns; i++) slots[i] = -1;
    for (int32_t c = 0; c < t->n_chr; c++) place(b, c);
  }
  if (grow((void **)&t->names, &b->names_cap, b->names_len + n, 1) ||
      grow((void **)&t->name_off, &b->offs_cap, (size_t)t->n_chr + 2, 8))
    return -1;
  if (t->n_chr == 0) t->name_off[0] = 0;
  memcpy(t->names + b->names_len, s, n);
  b->names_len += n;
  int32_t c = (int32_t)t->n_chr++;
  t->name_off[c + 1] = (int64_t)b->names_len;
  place(b, c);
  return c;
}

void fscl_free(fscl_snp_rows *t) {
  free(t->pos);
  free(t->freq);
  free(t->size);
  free(t->folded);
  free(t->chr);
  free(t->name_off);
  free(t->names);
  memset(t, 0, sizeof *t);
}

/* Parse the SNP file at path into *out: 0, or an errno value (out is then
   empty).  fscl_tpu/native/fastio.c:56-125's loop. */
int fscl_parse_snp_file(const char *path, fscl_snp_rows *out) {
  memset(out, 0, sizeof *out);
  FILE *f = fopen(path, "r");
  if (!f) return errno ? errno : EIO;

  accumulator b = {0};
  b.t = out;
  char *line = NULL;
  size_t cap = 0;
  int err = 0;
  int32_t prev = -1;

  while (getline(&line, &cap, f) != -1) {
    char *p = line;
    while (*p == ' ' || *p == '\t') p++;
    if (*p == '#' || *p == '\n' || *p == '\r' || *p == 0) continue;

    /* chr token */
    char *chr_start = p;
    while (*p && !isspace((unsigned char)*p)) p++;
    if (!*p) continue;
    size_t chr_len = (size_t)(p - chr_start);

    char *end;
    long long v_pos = strtoll(p, &end, 10);
    if (end == p) continue;
    p = end;
    long long v_freq = strtoll(p, &end, 10);
    if (end == p) continue;
    p = end;
    long long v_size = strtoll(p, &end, 10);
    if (end == p) continue;
    p = end;
    long long v_fold = strtoll(p, &end, 10);
    if (end == p) continue;

    if (prev < 0 || !same_name(out, prev, chr_start, chr_len)) {
      prev = name_code(&b, chr_start, chr_len);
      if (prev < 0) {
        err = ENOMEM;
        break;
      }
    }
    if (push_row(&b, v_pos, v_freq, v_size, v_fold, prev)) {
      err = ENOMEM;
      break;
    }
  }
  if (!err && ferror(f)) err = EIO;
  free(line);
  free(b.slots);
  fclose(f);
  if (err) fscl_free(out);
  return err;
}

/* Rows of '0'/'1' characters (rows[i], lens[i] bytes) to a uint8 matrix
   out[n_hap, n_poly], each entry its character minus '0', as fscl_tpu's
   parse_ms_haplotypes writes it: 0, or 1 + the index of the first row
   whose length is not n_poly (out is then partly written). */
int64_t fscl_parse_ms_haplotypes(const char *const *rows, const int64_t *lens,
                                 int64_t n_hap, int64_t n_poly, uint8_t *out) {
  for (int64_t i = 0; i < n_hap; i++) {
    if (lens[i] != n_poly) return i + 1;
    const char *src = rows[i];
    uint8_t *dst = out + i * n_poly;
    for (int64_t j = 0; j < n_poly; j++) dst[j] = (uint8_t)(src[j] - '0');
  }
  return 0;
}
