/* A JPEG transcoder in the manner of `jpegtran -arithmetic`, for the tests
 * of the port's arithmetic-coded JPEG reader: the coefficients of a JPEG
 * are written again, losslessly, with libjpeg's arithmetic (QM) coder or
 * its Huffman coder, under a scan script, restart interval and
 * conditioning given on the command line.
 *
 *   cc -O2 jpeg_arith_writer.c -ljpeg -o jpeg_arith_writer
 *   jpeg_arith_writer IN OUT [options]
 *
 *   -h              Huffman coding (the default is arithmetic coding)
 *   -p              libjpeg's simple progression (jpeg_simple_progression)
 *   -s SCRIPT       a scan script: scans separated by ';', each
 *                   "c[,c...]:Ss:Se:Ah:Al" with c the components' indexes
 *   -r N            a restart interval of N MCUs (restart_interval)
 *   -R N            a restart interval of N MCU rows (restart_in_rows)
 *   -d T:L:U        DC conditioning of table T (arith_dc_L, arith_dc_U)
 *   -k T:K          AC conditioning of table T (arith_ac_K)
 *   -t C:D:A        component C codes with DC table D and AC table A
 *   -y              marked YCCK (an Adobe marker with transform 2)
 *
 * Exits 0, or 1 with libjpeg's message on stderr.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include <jpeglib.h>

#define MAX_SCANS 64

static jpeg_scan_info scans[MAX_SCANS];

static int parse_script(const char *text) {
  int n = 0;
  const char *p = text;
  while (*p && n < MAX_SCANS) {
    jpeg_scan_info *s = &scans[n];
    s->comps_in_scan = 0;
    for (;;) {
      s->component_index[s->comps_in_scan++] = (int)strtol(p, (char **)&p, 10);
      if (*p != ',' || s->comps_in_scan == MAX_COMPS_IN_SCAN) break;
      p++;
    }
    if (sscanf(p, ":%d:%d:%d:%d", &s->Ss, &s->Se, &s->Ah, &s->Al) != 4) return -1;
    n++;
    p = strchr(p, ';');
    if (!p) break;
    p++;
  }
  return n;
}

int main(int argc, char **argv) {
  struct jpeg_decompress_struct src;
  struct jpeg_compress_struct dst;
  struct jpeg_error_mgr src_err, dst_err;
  if (argc < 3) {
    fprintf(stderr, "usage: %s IN OUT [options]\n", argv[0]);
    return 1;
  }
  FILE *in = fopen(argv[1], "rb");
  if (!in) {
    perror(argv[1]);
    return 1;
  }
  src.err = jpeg_std_error(&src_err);
  jpeg_create_decompress(&src);
  dst.err = jpeg_std_error(&dst_err);
  jpeg_create_compress(&dst);
  jpeg_stdio_src(&src, in);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr *coefs = jpeg_read_coefficients(&src);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = TRUE;
  for (int i = 3; i < argc; i++) {
    const char *opt = argv[i];
    const char *val = i + 1 < argc ? argv[i + 1] : "";
    int a, b, c;
    if (!strcmp(opt, "-h")) {
      dst.arith_code = FALSE;
      dst.optimize_coding = TRUE;
      continue;
    }
    if (!strcmp(opt, "-p")) {
      jpeg_simple_progression(&dst);
      continue;
    }
    if (!strcmp(opt, "-y")) {
      dst.jpeg_color_space = JCS_YCCK;
      dst.write_Adobe_marker = TRUE;
      dst.write_JFIF_header = FALSE;
      continue;
    }
    i++;
    if (!strcmp(opt, "-s")) {
      int n = parse_script(val);
      if (n <= 0) {
        fprintf(stderr, "bad scan script %s\n", val);
        return 1;
      }
      dst.scan_info = scans;
      dst.num_scans = n;
    } else if (!strcmp(opt, "-r")) {
      dst.restart_interval = (unsigned int)atoi(val);
    } else if (!strcmp(opt, "-R")) {
      dst.restart_in_rows = atoi(val);
    } else if (!strcmp(opt, "-d") && sscanf(val, "%d:%d:%d", &a, &b, &c) == 3) {
      dst.arith_dc_L[a] = (UINT8)b;
      dst.arith_dc_U[a] = (UINT8)c;
    } else if (!strcmp(opt, "-k") && sscanf(val, "%d:%d", &a, &b) == 2) {
      dst.arith_ac_K[a] = (UINT8)b;
    } else if (!strcmp(opt, "-t") && sscanf(val, "%d:%d:%d", &a, &b, &c) == 3) {
      dst.comp_info[a].dc_tbl_no = b;
      dst.comp_info[a].ac_tbl_no = c;
    } else {
      fprintf(stderr, "bad option %s %s\n", opt, val);
      return 1;
    }
  }
  FILE *out = fopen(argv[2], "wb");
  if (!out) {
    perror(argv[2]);
    return 1;
  }
  jpeg_stdio_dest(&dst, out);
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  fclose(in);
  return fclose(out) ? 1 : 0;
}
