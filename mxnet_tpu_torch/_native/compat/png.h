/* The declarations of libpng's simplified read API (libpng 1.6) that
 * imgdecode.cc uses, for machines that ship the library without its
 * header (e.g. only the copy inside Pillow's wheel). The build searches
 * this directory after the system's include directories, so an
 * installed png.h always wins. The image's version field is checked by
 * the library. */
#ifndef MXNET_COMPAT_PNG_H
#define MXNET_COMPAT_PNG_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef uint32_t png_uint_32;
typedef int32_t png_int_32;
typedef struct png_control *png_controlp;
typedef struct png_color_struct {
  unsigned char red, green, blue;
} png_color;
typedef const png_color *png_const_colorp;

#define PNG_IMAGE_VERSION 1

typedef struct {
  png_controlp opaque;
  png_uint_32 version;
  png_uint_32 width;
  png_uint_32 height;
  png_uint_32 format;
  png_uint_32 flags;
  png_uint_32 colormap_entries;
  png_uint_32 warning_or_error;
  char message[64];
} png_image, *png_imagep;

#define PNG_FORMAT_FLAG_ALPHA    0x01U
#define PNG_FORMAT_FLAG_COLOR    0x02U
#define PNG_FORMAT_FLAG_LINEAR   0x04U
#define PNG_FORMAT_FLAG_COLORMAP 0x08U
#define PNG_FORMAT_RGB  PNG_FORMAT_FLAG_COLOR

#define PNG_IMAGE_SAMPLE_CHANNELS(fmt) \
  (((fmt) & (PNG_FORMAT_FLAG_COLOR | PNG_FORMAT_FLAG_ALPHA)) + 1)
#define PNG_IMAGE_SAMPLE_COMPONENT_SIZE(fmt) \
  ((((fmt) & PNG_FORMAT_FLAG_LINEAR) >> 2) + 1)
#define PNG_IMAGE_PIXEL_(test, fmt) \
  (((fmt) & PNG_FORMAT_FLAG_COLORMAP) ? 1 : test(fmt))
#define PNG_IMAGE_PIXEL_CHANNELS(fmt) \
  PNG_IMAGE_PIXEL_(PNG_IMAGE_SAMPLE_CHANNELS, fmt)
#define PNG_IMAGE_PIXEL_COMPONENT_SIZE(fmt) \
  PNG_IMAGE_PIXEL_(PNG_IMAGE_SAMPLE_COMPONENT_SIZE, fmt)
#define PNG_IMAGE_ROW_STRIDE(image) \
  (PNG_IMAGE_PIXEL_CHANNELS((image).format) * (image).width)
#define PNG_IMAGE_BUFFER_SIZE(image, row_stride) \
  (PNG_IMAGE_PIXEL_COMPONENT_SIZE((image).format) * (image).height * \
   (row_stride))
#define PNG_IMAGE_SIZE(image) \
  PNG_IMAGE_BUFFER_SIZE(image, PNG_IMAGE_ROW_STRIDE(image))

int png_image_begin_read_from_memory(png_imagep image, const void *memory,
                                     size_t size);
int png_image_finish_read(png_imagep image, png_const_colorp background,
                          void *buffer, png_int_32 row_stride,
                          void *colormap);
void png_image_free(png_imagep image);

#ifdef __cplusplus
}
#endif

#endif  /* MXNET_COMPAT_PNG_H */
